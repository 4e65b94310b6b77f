"""The port's poseutils and parametric projection against the JAX package:
values at 1e-12 (f64, r = 0 included) and autograd Jacobians against
jax.jacrev at 1e-10."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mrcal_tpu.poseutils as jpu
from mrcal_tpu.lensmodels import project_core as j_project_core
import mrcal_tpu_torch.poseutils as tpu
from mrcal_tpu_torch.lensmodels import project_core as t_project_core
from mrcal_tpu_torch import lensmodel_num_params

PARAMETRIC = ["LENSMODEL_PINHOLE", "LENSMODEL_STEREOGRAPHIC",
              "LENSMODEL_LONLAT", "LENSMODEL_LATLON", "LENSMODEL_OPENCV4",
              "LENSMODEL_OPENCV5", "LENSMODEL_OPENCV8", "LENSMODEL_OPENCV12"]


def _close(a, b, tol):
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    scale = max(1.0, float(np.abs(b).max()))
    assert np.abs(a - b).max() <= tol * scale, np.abs(a - b).max()


def _rotations(rng, N=20):
    r = rng.normal(size=(N, 3)) * 0.7
    r[0] = 0.0                        # the small-angle branch
    r[1] = [1e-10, -2e-10, 0.5e-10]
    return r


POSE_FNS = [
    ("R_from_r", lambda m, r, x: m._R_from_r(r)),
    ("compose_r", lambda m, r, x: m._compose_r(r, x)),
    ("rotate_point_r", lambda m, r, x: m._rotate_point_r(r, x)),
    ("rotate_point_r_inverted",
     lambda m, r, x: m._rotate_point_r(r, x, inverted=True)),
    ("skew_symmetric", lambda m, r, x: m.skew_symmetric(r)),
]


@pytest.mark.parametrize("name,fn", POSE_FNS, ids=[n for n, _ in POSE_FNS])
def test_poseutils_values(name, fn):
    rng = np.random.default_rng(1)
    r = _rotations(rng)
    x = rng.normal(size=(20, 3))
    _close(fn(tpu, torch.as_tensor(r), torch.as_tensor(x)).numpy(),
           fn(jpu, jnp.asarray(r), jnp.asarray(x)), 1e-12)


def test_rt_compose_and_transform_values():
    rng = np.random.default_rng(2)
    rt0 = np.concatenate([_rotations(rng), rng.normal(size=(20, 3))], -1)
    rt1 = np.concatenate([_rotations(rng)[::-1], rng.normal(size=(20, 3))],
                         -1)
    x = rng.normal(size=(20, 3))
    _close(tpu._compose_rt2(torch.as_tensor(rt0), torch.as_tensor(rt1)),
           jpu._compose_rt2(jnp.asarray(rt0), jnp.asarray(rt1)), 1e-12)
    for inv in (False, True):
        _close(tpu._transform_point_rt(torch.as_tensor(rt0),
                                       torch.as_tensor(x), inverted=inv),
               jpu._transform_point_rt(jnp.asarray(rt0), jnp.asarray(x),
                                       inverted=inv), 1e-12)


def test_rotation_gradients_finite_at_zero():
    """torch.where differentiates both branches; the safe-input pattern
    keeps the gradient finite at r = 0."""
    r = torch.zeros(3, dtype=torch.float64, requires_grad=True)
    x = torch.tensor([0.3, -0.2, 1.0], dtype=torch.float64)
    for f in (lambda r: tpu._R_from_r(r).sum(),
              lambda r: tpu._rotate_point_r(r, x).sum(),
              lambda r: tpu._compose_r(r, x).sum()):
        (g,) = torch.autograd.grad(f(r), r)
        assert torch.isfinite(g).all()


def test_compose_rt_jacobian_matches_jacrev():
    rng = np.random.default_rng(3)
    rt0 = np.concatenate([rng.normal(size=3) * 0.5, rng.normal(size=3)])
    rt1 = np.concatenate([rng.normal(size=3) * 0.5, rng.normal(size=3)])
    for argnum in (0, 1):
        Jj = jax.jacrev(jpu._compose_rt2, argnums=argnum)(
            jnp.asarray(rt0), jnp.asarray(rt1))
        Jt = torch.autograd.functional.jacobian(
            tpu._compose_rt2, (torch.as_tensor(rt0), torch.as_tensor(rt1)))
        _close(Jt[argnum].numpy(), Jj, 1e-10)


def _intrinsics(model, rng):
    n = lensmodel_num_params(model)
    intr = np.zeros(n)
    intr[:4] = [750.0, 748.0, 399.5, 299.5]
    intr[4:] = rng.normal(size=n - 4) * 0.01
    return intr


@pytest.mark.parametrize("model", PARAMETRIC)
def test_project_core_values_and_jacobians(model):
    rng = np.random.default_rng(4)
    v = np.concatenate([rng.normal(size=(30, 2)) * 0.4,
                        1.0 + rng.uniform(size=(30, 1))], axis=-1)
    intr = _intrinsics(model, rng)
    q_t = t_project_core(torch.as_tensor(v), torch.as_tensor(intr), model)
    q_j = j_project_core(jnp.asarray(v), jnp.asarray(intr), model)
    _close(q_t.numpy(), q_j, 1e-12)

    # Jacobian of one projection wrt the point and the intrinsics
    Jj = jax.jacrev(lambda vv, ii: j_project_core(vv, ii, model),
                    argnums=(0, 1))(jnp.asarray(v[0]), jnp.asarray(intr))
    Jt = torch.autograd.functional.jacobian(
        lambda vv, ii: t_project_core(vv, ii, model),
        (torch.as_tensor(v[0]), torch.as_tensor(intr)))
    for a, b in zip(Jt, Jj):
        _close(a.numpy(), b, 1e-10)


@pytest.mark.parametrize("model", ["LENSMODEL_CAHVOR",
                                   "LENSMODEL_CAHVORE_linearity=0.00"])
def test_unported_models_raise(model):
    n = lensmodel_num_params(model)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_project_core(torch.ones(3, dtype=torch.float64),
                       torch.ones(n, dtype=torch.float64), model)
