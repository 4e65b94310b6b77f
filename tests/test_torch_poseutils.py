"""The port's public pose functions against mrcal_tpu.poseutils on numpy
inputs from a seed, values and get_gradients outputs to 1e-12, in float64
on the CPU: variadic composition, inverted0/inverted1, broadcasting and
out=; every function of the JAX package's poseutils: rotations, rt and Rt
transforms, the tiny-gradient compositions, quaternions and
R_aligned_to_vector."""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

import mrcal_tpu.poseutils as jpose
import mrcal_tpu_torch
from mrcal_tpu_torch import poseutils as tpose

rng = np.random.default_rng(11)
R3 = rng.normal(size=(3, 3)) * 0.7
RT3 = np.concatenate([R3, rng.normal(size=(3, 3))], axis=-1)
R211 = rng.normal(size=(2, 1, 3)) * 0.7       # broadcasts against (3, 3)
RT216 = np.concatenate([R211, rng.normal(size=(2, 1, 3))], axis=-1)
X3 = rng.normal(size=(3, 3)) * 4.0
# a rotation at the origin: the small-angle branches
R3[1] = 0.0
RT3[1, :3] = 0.0

# rotation matrices, one near pi (quat_from_R's other pivots), and Rt
# transforms; unnormalized quaternions and qt
RM4 = tpose._R_from_r(torch.as_tensor(
    np.concatenate([R3, [[2.9, 0.3, -0.2]]]))).numpy()
RT43 = np.concatenate([RM4[:3], RT3[:, None, 3:]], axis=-2)
Q4 = rng.normal(size=(3, 4))
QT7 = np.concatenate([Q4, rng.normal(size=(3, 3))], axis=-1)

# the plain gradients ride in the inverted cases: inverted0 takes the
# second argument's plain gradient, inverted1 the first's
CASES = {
    "R_from_r": ("R_from_r", (R3,), dict(get_gradients=True)),
    "compose_r three": ("compose_r", (R3, R211, R3[::-1]), {}),
    "compose_r inverted0": ("compose_r", (R3, R3[::-1]),
                            dict(get_gradients=True, inverted0=True)),
    "compose_r inverted1": ("compose_r", (R3, R211),
                            dict(get_gradients=True, inverted1=True)),
    "compose_rt three": ("compose_rt", (RT3, RT216, RT3[::-1]), {}),
    "compose_rt inverted0": ("compose_rt", (RT216, RT3),
                             dict(get_gradients=True, inverted0=True)),
    "compose_rt inverted1": ("compose_rt", (RT3, RT3[::-1]),
                             dict(get_gradients=True, inverted1=True)),
    "rotate_point_r inverted": ("rotate_point_r", (R211, X3),
                                dict(get_gradients=True, inverted=True)),
    "transform_point_rt": ("transform_point_rt", (RT216, X3),
                           dict(get_gradients=True)),
    "r_from_R": ("r_from_R", (RM4,), dict(get_gradients=True)),
    "invert_R": ("invert_R", (RM4,), {}),
    "rt_from_Rt": ("rt_from_Rt", (RT43,), dict(get_gradients=True)),
    "Rt_from_rt": ("Rt_from_rt", (RT3,), dict(get_gradients=True)),
    "invert_Rt": ("invert_Rt", (RT43,), {}),
    "invert_rt": ("invert_rt", (RT216,), dict(get_gradients=True)),
    "compose_Rt three": ("compose_Rt", (RT43, RT43[::-1], RT43), {}),
    "compose_Rt inverted0": ("compose_Rt", (RT43, RT43[::-1]),
                             dict(inverted0=True)),
    "compose_Rt inverted1": ("compose_Rt", (RT43, RT43[:1]),
                             dict(inverted1=True)),
    "transform_point_Rt": ("transform_point_Rt", (RT43, X3),
                           dict(get_gradients=True)),
    "transform_point_Rt inverted": ("transform_point_Rt", (RT43[:1], X3),
                                    dict(get_gradients=True,
                                         inverted=True)),
    "compose_r_tinyr0_gradientr0": ("compose_r_tinyr0_gradientr0", (R3,),
                                    {}),
    "compose_r_tinyr1_gradientr1": ("compose_r_tinyr1_gradientr1", (R211,),
                                    {}),
    "compose_rt_tinyrt0_gradientrt0": ("compose_rt_tinyrt0_gradientrt0",
                                       (RT3,), {}),
    "compose_rt_tinyrt1_gradientrt1": ("compose_rt_tinyrt1_gradientrt1",
                                       (RT216,), {}),
    "quat_from_R": ("quat_from_R", (RM4,), {}),
    "R_from_quat": ("R_from_quat", (Q4,), {}),
    "qt_from_Rt": ("qt_from_Rt", (RT43,), {}),
    "Rt_from_qt": ("Rt_from_qt", (QT7,), {}),
    "R_aligned_to_vector": ("R_aligned_to_vector", (X3,), {}),
}


@pytest.fixture(scope="module")
def results():
    """Every case through the port and through the JAX package, jitted
    (its jacfwd runs op by op eagerly): the JAX compiles run in a thread,
    beside the port's first gradient (torch.func's one-time start)."""
    def jax_cases():
        # one compile for every case: ~0.5-1.4 s each apart
        def all_cases(args):
            return {case: getattr(jpose, name)(*args[case], **kw)
                    for case, (name, _, kw) in CASES.items()}
        out = jax.jit(all_cases)({case: args for case, (_, args, _)
                                  in CASES.items()})
        return {case: _outputs(r) for case, r in out.items()}

    with ThreadPoolExecutor(1) as pool:
        want = pool.submit(jax_cases)
        got = {case: _outputs(getattr(mrcal_tpu_torch, name)(
            *args, device="cpu", **kw))
            for case, (name, args, kw) in CASES.items()}
        return got, want.result(timeout=300)


def _outputs(r):
    return [np.asarray(t) for t in (r if isinstance(r, tuple) else (r,))]


def _close(a, b, tol=1e-12):
    """|a - b| <= tol * max(1, max|b|)."""
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= tol * max(1.0, float(np.abs(b).max())), \
        np.abs(a - b).max()


@pytest.mark.parametrize("case", CASES)
def test_matches_jax(case, results):
    got, want = (r[case] for r in results)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("case", ["R_from_r", "compose_rt inverted0",
                                  "compose_r three", "transform_point_rt",
                                  "rt_from_Rt", "compose_Rt inverted1"])
def test_out(case, results):
    """out= (a tuple of arrays with get_gradients) receives the result, and
    is what the call returns."""
    name, args, kw = CASES[case]
    want = results[1][case]
    out = tuple(np.zeros_like(w) for w in want)
    got = getattr(mrcal_tpu_torch, name)(
        *args, device="cpu", out=out if len(out) > 1 else out[0], **kw)
    got = got if isinstance(got, tuple) else (got,)
    for g, o, w in zip(got, out, want):
        assert g is o
        _close(o, w)


@pytest.mark.parametrize("name,arg", [("compose_r", R3),
                                      ("compose_rt", RT3)])
@pytest.mark.parametrize("kw", [dict(get_gradients=True),
                                dict(inverted0=True), dict(inverted1=True)])
def test_two_arguments_only(name, arg, kw):
    """get_gradients and inverted0/1 take exactly two transforms, as the
    reference has it; any other count raises ValueError."""
    for n in (1, 3):
        with pytest.raises(ValueError):
            getattr(mrcal_tpu_torch, name)(*([arg] * n), device="cpu", **kw)
        with pytest.raises(ValueError):
            getattr(jpose, name)(*([arg] * n), **kw)


def test_public_names_are_not_the_cores():
    """The package exports the wrappers, and the solver keeps its cores."""
    for name in ("R_from_r", "compose_r", "compose_rt", "rotate_point_r",
                 "transform_point_rt"):
        assert getattr(mrcal_tpu_torch, name) is getattr(tpose, name)
    for core in ("_R_from_r", "_compose_r", "_compose_rt2",
                 "_rotate_point_r", "_transform_point_rt"):
        assert getattr(mrcal_tpu_torch, core[1:], None) is not \
            getattr(tpose, core)
    # a tensor result on the device asked for, in the input's dtype
    R = mrcal_tpu_torch.R_from_r(R3.astype(np.float32), device="cpu")
    assert R.dtype == torch.float32 and R.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mrcal_tpu_torch.compose_rt(RT3, RT3)


@pytest.mark.parametrize("name", ["identity_R", "identity_r", "identity_Rt",
                                  "identity_rt", "identity_qt"])
def test_identities(name):
    got = getattr(mrcal_tpu_torch, name)(device="cpu")
    assert got.dtype == torch.float64
    _close(got.numpy(), np.asarray(getattr(jpose, name)()), 0)
    assert getattr(mrcal_tpu_torch, name)(
        torch.float32, device="cpu").dtype == torch.float32


def test_pose_functions_exported():
    """The package exports every pose function the JAX package does."""
    assert sorted(tpose.__all__) == sorted(jpose.__all__)
    for name in jpose.__all__:
        assert getattr(mrcal_tpu_torch, name) is getattr(tpose, name)
