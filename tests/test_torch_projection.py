"""The port's poseutils and parametric projection against the JAX package:
values at 1e-12 (f64, r = 0 included) and autograd Jacobians against
jax.jacrev at 1e-10; project/unproject with their gradients for every
ported family (the splined one at 9x7 knots) and the special-model pairs
at 1e-10 relative; unproject_core after 1, 3 and 25 Gauss-Newton steps
(OPENCV8, CAHVOR, CAHVORE, splined) at 1e-12 relative."""


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

from test_torch_residuals import jax_reference_pool
from test_torch_residuals import torch_threads  # noqa: F401

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
    _check_project_core(model)


def _check_project_core(model):
    """Values at 1e-12 and one point's Jacobians (point, intrinsics)
    against jax.jacrev at 1e-10."""
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
    """CAHVOR and CAHVORE, once refused, project as the parametric
    families do: values and Jacobians against the JAX package (their
    unprojection and the other linearities: tests/test_torch_cahvor.py)."""
    _check_project_core(model)


# ----------------------------------------------------------------------------
# project / unproject with gradients, and the special-model pairs
# ----------------------------------------------------------------------------

SPLINED = "LENSMODEL_SPLINED_STEREOGRAPHIC_order=3_Nx=9_Ny=7_fov_x_deg=120"
FAMILIES = PARAMETRIC + [SPLINED]
# unproject(normalize=True) too for these (the normalization is one more
# chain-rule factor, the same for every family)
NORMALIZED = ("LENSMODEL_LONLAT", "LENSMODEL_OPENCV8", SPLINED)
SPECIAL = ["pinhole", "stereographic", "lonlat", "latlon"]
# the JAX references' processes: the OPENCV and splined unprojections are
# jitted Gauss-Newton solves with gradients, seconds of compile each
GROUPS = (PARAMETRIC[:5], ["LENSMODEL_OPENCV5", "LENSMODEL_OPENCV8"],
          ["LENSMODEL_OPENCV12", "special"], [SPLINED])


def _projection_inputs(model):
    rng = np.random.default_rng(FAMILIES.index(model))
    v = np.concatenate([rng.normal(size=(2, 5, 2)) * 0.4,
                        1.0 + rng.uniform(size=(2, 5, 1))], axis=-1)
    q = rng.uniform(150, 650, size=(2, 5, 2)) * [1.0, 0.75]
    return v, q, _intrinsics(model, rng)


def _special_inputs():
    rng = np.random.default_rng(8)
    v = np.concatenate([rng.normal(size=(6, 2)) * 0.4,
                        1.0 + rng.uniform(size=(6, 1))], axis=-1)
    q = rng.normal(size=(6, 2)) * 0.3
    return v, q, np.array([700., 690., 399.5, 299.5])


def _jax_projection_refs(group):
    """The JAX package's project/unproject with gradients (jitted) for the
    families of `group`; "special": the special pairs."""
    import mrcal_tpu.projections as jproj
    out = {}
    for model in group:
        if model == "special":
            v, q, f = _special_inputs()

            def special(v, q, f):
                return {f"{d}_{s}": getattr(jproj, f"{d}_{s}")(
                    v if d == "project" else q, f, get_gradients=True)
                    for s in SPECIAL for d in ("project", "unproject")}
            out.update(jax.jit(special)(v, q, f))
            continue
        v, q, intr = _projection_inputs(model)
        norms = (False, True) if model in NORMALIZED else (False,)

        def f(v, q, intr):
            out = {f"unproject {n}": jproj.unproject(
                q, model, intr, normalize=n, get_gradients=True)
                for n in norms}
            out["project"] = jproj.project(v, model, intr,
                                           get_gradients=True)
            return out
        out[model] = jax.jit(f)(v, q, intr)
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module", autouse=True)
def projection_refs():
    """The JAX references' processes, started with the module's first
    test: {family or special pair: a future of its group's references}."""
    with jax_reference_pool(len(GROUPS), compiled=False) as pool:
        futures = [pool.submit(_jax_projection_refs, g) for g in GROUPS]
        yield {key: fut for g, fut in zip(GROUPS, futures)
               for key in (g if "special" not in g else
                           g[:-1] + [f"{d}_{s}" for s in SPECIAL
                                     for d in ("project", "unproject")])}


def _projection_ref(projection_refs, key):
    return projection_refs[key].result(timeout=600)[key]


@pytest.mark.parametrize("model", FAMILIES)
def test_project_unproject_gradients_match_jax(projection_refs, model):
    """Values and gradients to 1e-10 relative; the iterative models'
    unprojection gradients come from the implicit function theorem at
    the converged point (the JAX package differentiates through its
    fixed-iteration solve), which agree to the solve's convergence."""
    import mrcal_tpu_torch.projections as tproj
    v, q, intr = _projection_inputs(model)
    ref = _projection_ref(projection_refs, model)
    got = tproj.project(v, model, intr, get_gradients=True, device="cpu")
    assert [g.shape for g in got] == [(2, 5, 2), (2, 5, 2, 3),
                                      (2, 5, 2, len(intr))]
    for a, b in zip(got, ref["project"]):
        _close(a.numpy(), b, 1e-10)
    for n in (False, True):
        if f"unproject {n}" not in ref:
            continue
        got = tproj.unproject(q, model, intr, normalize=n,
                              get_gradients=True, device="cpu")
        for a, b in zip(got, ref[f"unproject {n}"]):
            _close(a.numpy(), b, 1e-10)


# the models whose unproject_core iterates, and its Gauss-Newton counts
ITERATIVE = ["LENSMODEL_OPENCV8", "LENSMODEL_CAHVOR",
             "LENSMODEL_CAHVORE_linearity=0.37", SPLINED]
GAUSS_NEWTON_STEPS = [1, 3, 25]


def _unproject_core_inputs(model):
    if model in FAMILIES:
        _, q, intr = _projection_inputs(model)
        return q, intr
    from test_torch_cahvor import _intrinsics as cahvor_intrinsics
    q = np.random.default_rng(9).uniform(150, 650, size=(2, 5, 2))
    return q * [1.0, 0.75], cahvor_intrinsics(model)


@pytest.mark.parametrize("iterations", GAUSS_NEWTON_STEPS)
@pytest.mark.parametrize("model", ITERATIVE)
def test_unproject_core_iterations_match_jax(model, iterations):
    """unproject_core(..., iterations=k) is the JAX package's after the
    same k Gauss-Newton steps, at 1e-12 relative."""
    from mrcal_tpu.lensmodels import unproject_core as j_unproject_core
    from mrcal_tpu_torch import unproject_core
    q, intr = _unproject_core_inputs(model)
    v_j = np.asarray(jax.jit(j_unproject_core, static_argnums=(2, 3))(
        q, intr, model, iterations))
    v_t = unproject_core(torch.as_tensor(q), torch.as_tensor(intr), model,
                         iterations=iterations).numpy()
    assert v_t.shape == v_j.shape == (2, 5, 3)
    assert np.abs(v_t - v_j).max() <= 1e-12 * np.abs(v_j).max()


@pytest.mark.parametrize("model", ITERATIVE + ["LENSMODEL_PINHOLE"])
def test_unproject_core_defaults_to_25_iterations(model):
    """The default count is 25, bit for bit; the closed-form models
    ignore the count."""
    from mrcal_tpu_torch import unproject_core
    q, intr = (torch.as_tensor(a) for a in _unproject_core_inputs(model))
    v = unproject_core(q, intr, model)
    assert torch.equal(v, unproject_core(q, intr, model, iterations=25))
    if model == "LENSMODEL_PINHOLE":
        assert torch.equal(v, unproject_core(q, intr, model, iterations=1))
    else:
        assert not torch.equal(v, unproject_core(q, intr, model,
                                                 iterations=1))


@pytest.mark.parametrize("special", SPECIAL)
def test_special_pairs_match_jax(projection_refs, special):
    import mrcal_tpu_torch.projections as tproj
    v, q, f = _special_inputs()
    for d, x in (("project", v), ("unproject", q)):
        got = getattr(tproj, f"{d}_{special}")(x, f, get_gradients=True,
                                               device="cpu")
        for a, b in zip(got, _projection_ref(projection_refs,
                                             f"{d}_{special}")):
            _close(a.numpy(), b, 1e-10)
    # the default fxycxy is (1, 1, 0, 0)
    _close(getattr(tproj, f"project_{special}")(v, device="cpu").numpy(),
           getattr(tproj, f"project_{special}")(
               v, [1., 1., 0., 0.], device="cpu").numpy(), 0)


def test_projection_out_and_device():
    """out= receives the result; no device means the card, and without one
    the functions raise rather than run on the CPU."""
    import mrcal_tpu_torch.projections as tproj
    v, q, intr = _projection_inputs("LENSMODEL_OPENCV4")
    out = (np.zeros((2, 5, 2)), np.zeros((2, 5, 2, 3)),
           np.zeros((2, 5, 2, 8)))
    ret = tproj.project(v, "LENSMODEL_OPENCV4", intr, get_gradients=True,
                        out=out, device="cpu")
    assert ret is out
    _close(out[0], tproj.project(v, "LENSMODEL_OPENCV4", intr,
                                 device="cpu").numpy(), 0)
    if not torch.cuda.is_available():
        for fn, x in ((tproj.project, v), (tproj.unproject, q)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                fn(x, "LENSMODEL_OPENCV4", intr)
