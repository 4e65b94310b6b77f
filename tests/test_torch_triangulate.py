"""The port's triangulate() against the JAX package's, in float64 on the
CPU, on a small two-camera OPENCV4 scene (tests/test_triangulation.py's:
make_scene's two cameras and a 8x6 board, here 12 frames from the port's
problems.stereo_opencv8_2cam, solved by the port; both packages get the
solved optimization_inputs) and four points seen by both cameras:

  - every return structure (p; p and Var_p_calibration; p and
    Var_p_observation; all four), a stdev of 0, an observation
    correlation of 0.1, stabilize_coords on and off, leading dims (), (3,)
    and (2, 2), and each of the five non-Lindstrom methods: p to 1e-10
    relative, the covariances to 1e-8 of their largest entry, and the
    joint covariance equal to the calibration one plus the block-diagonal
    observation one to 1e-12;
  - the JAX package's raises: a negative stdev of either kind,
    triangulate_lindstrom with a stdev, models without
    optimization_inputs, a moving camera;
  - triangulate_lindstrom's p, which the JAX package's triangulate()
    cannot give (it passes t01 where Rt01 is due, and raises): against
    its triangulate_lindstrom of the unprojected local rays.

The JAX references cover the leading dims at once: each is one call on
the four points as (2, 2), whose point blocks are the references of the
port's calls on fewer points (a point's covariance with another does not
depend on the rest); and the four other methods' calibration noise,
unstabilized, is one call, each method on its own copy of the points
(jax_references.each_method).  They run in two processes, started
before the first test (jax_reference_pool)."""

import tempfile

import numpy as np
import pytest
import torch

import mrcal_tpu_torch as T
from mrcal_tpu_torch import problems

from jax_references import (jax_reference_pool, raising_calls,
                            triangulate_references)
from test_torch_residuals import torch_threads  # noqa: F401

P_TOL = 1e-10
COV_TOL = 1e-8
JOINT_TOL = 1e-12
P_TRUE = np.array([[[0.1, -0.2, 3.0], [-0.4, 0.1, 2.0]],
                   [[0.3, 0.3, 5.0], [0.2, 0.1, 4.0]]])
STDEVS = dict(q_calibration_stdev=0.3, q_observation_stdev=0.2,
              q_observation_stdev_correlation=0.1)
METHODS = ("geometric", "leecivera_l1", "leecivera_linf", "leecivera_wmid2")
# the JAX references: name -> (method, keyword arguments); a tuple of
# methods is one call on a copy of the points for each
REFS = dict(
    both=("leecivera_mid2", STDEVS),
    calibration=(METHODS, dict(q_calibration_stdev=0.3,
                               stabilize_coords=False)),
    **{m: (m, dict(q_observation_stdev=0.2)) for m in METHODS})
# the references of each JAX process, in order: the second reaches
# "calibration", which takes the JAX package's J of the solve, after the
# first has computed it (jax_references.share_jax_evaluations)
CHILDREN = (("both", "raises"), METHODS + ("calibration",))


def solved_oi():
    oi = problems.stereo_opencv8_2cam(12, "LENSMODEL_OPENCV4", 8, 6,
                                      device="cpu")
    T.optimize(device="cpu", **oi)
    return oi


def observations(oi):
    """q (2, 2, 2 cameras, 2) of P_TRUE, from the solved models."""
    m0, m1 = (T.cameramodel(optimization_inputs=oi, icam_intrinsics=i)
              for i in (0, 1))
    q0 = T.project(P_TRUE, *m0.intrinsics(), device="cpu")
    p1 = T.transform_point_rt(m1.rt_cam_ref(), P_TRUE, device="cpu")
    q1 = T.project(p1, *m1.intrinsics(), device="cpu")
    return torch.stack([q0, q1], dim=-2).numpy()


@pytest.fixture(scope="module")
def scene():
    oi = solved_oi()
    return oi, observations(oi)


@pytest.fixture(scope="module")
def jax_refs(scene):
    """The references of CHILDREN, from as many processes started at
    once."""
    with tempfile.TemporaryDirectory() as shared, \
            jax_reference_pool(len(CHILDREN)) as pool:
        futures = [pool.submit(triangulate_references,
                               {n: REFS.get(n) for n in names}, *scene,
                               shared)
                   for names in CHILDREN]
        yield {name: f for names, f in zip(CHILDREN, futures)
               for name in names}


def _ref(jax_refs, name):
    return jax_refs[name].result(timeout=600)[name]


@pytest.fixture(scope="module")
def models(scene):
    return [T.cameramodel(optimization_inputs=scene[0], icam_intrinsics=i)
            for i in (0, 1)]


def _close(a, b, tol):
    """|a - b| <= tol * max|b|."""
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= tol * np.abs(b).max(), \
        (np.abs(a - b).max(), np.abs(b).max())


def _points(V, sel):
    """The block of the points sel (a tuple of flat indices into the four
    points) of a (2, 2, 3, 2, 2, 3) covariance."""
    V = np.asarray(V).reshape(4, 3, 4, 3)
    return V[np.ix_(sel, range(3), sel, range(3))]


STRUCTURES = {
    "p": {},
    "calibration": dict(q_calibration_stdev=0.3),
    "observation": dict(q_observation_stdev=0.2,
                        q_observation_stdev_correlation=0.1),
    "both": STDEVS,
}


@pytest.mark.parametrize("structure", STRUCTURES)
def test_return_structures_match_jax(jax_refs, scene, models, structure):
    p, Vc, Vo, Vj = _ref(jax_refs, "both")
    out = T.triangulate(scene[1], models, device="cpu",
                        **STRUCTURES[structure])
    want = dict(p=p, calibration=(p, Vc), observation=(p, Vo),
                both=(p, Vc, Vo, Vj))[structure]
    if structure == "p":
        out, want = (out,), (want,)
    assert len(out) == len(want)
    for got in out:
        assert torch.is_tensor(got) and got.dtype == torch.float64
    _close(out[0], want[0], P_TOL)
    for got, w in zip(out[1:], want[1:]):
        _close(got, w, COV_TOL)


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)], ids=str)
def test_leading_dims_match_jax(jax_refs, scene, models, lead):
    p, Vc, Vo, Vj = _ref(jax_refs, "both")
    sel = tuple(range(int(np.prod(lead))))
    q = scene[1].reshape(4, 2, 2)[list(sel)].reshape(lead + (2, 2))
    got = T.triangulate(q, models, device="cpu", **STDEVS)
    _close(got[0], p.reshape(4, 3)[list(sel)].reshape(lead + (3,)), P_TOL)
    _close(got[1], _points(Vc, sel).reshape(lead + (3,) + lead + (3,)),
           COV_TOL)
    _close(got[2], Vo.reshape(4, 3, 3)[list(sel)].reshape(lead + (3, 3)),
           COV_TOL)
    _close(got[3], _points(Vj, sel).reshape(lead + (3,) + lead + (3,)),
           COV_TOL)


def test_joint_is_calibration_plus_observation(scene, models):
    _, Vc, Vo, Vj = (a.numpy() for a in T.triangulate(
        scene[1], models, device="cpu", **STDEVS))
    Vc, Vj = Vc.reshape(4, 3, 4, 3), Vj.reshape(4, 3, 4, 3)
    blockdiag = np.zeros_like(Vc)
    for i, V in enumerate(Vo.reshape(4, 3, 3)):
        blockdiag[i, :, i, :] = V
    _close(Vj, Vc + blockdiag, JOINT_TOL)
    # the cross-point terms are there
    assert np.abs(Vc[0, :, 1, :]).max() > 1e-3 * np.abs(Vc).max()


def _method_calibration_ref(jax_refs, method):
    """The method's Var_p_calibration, unstabilized, (2, 2, 3, 2, 2, 3):
    its copy of the points in the call of every method."""
    k = METHODS.index(method)
    V = _ref(jax_refs, "calibration")[1].reshape(len(METHODS), 4, 3,
                                                 len(METHODS), 4, 3)
    return V[k, :, :, k].reshape(2, 2, 3, 2, 2, 3)


def test_unstabilized_matches_jax(jax_refs, scene, models):
    want = _method_calibration_ref(jax_refs, "geometric")
    _, got = T.triangulate(scene[1], models, device="cpu",
                           method=T.triangulate_geometric,
                           q_calibration_stdev=0.3, stabilize_coords=False)
    _close(got, want, COV_TOL)
    _, stabilized = T.triangulate(scene[1], models, device="cpu",
                                  method=T.triangulate_geometric,
                                  q_calibration_stdev=0.3)
    assert np.abs((got - stabilized).numpy()).max() > \
        1e-3 * np.abs(want).max()


@pytest.mark.parametrize("method", METHODS)
def test_methods_match_jax(jax_refs, scene, models, method):
    p, Vo = _ref(jax_refs, method)
    Vc = _method_calibration_ref(jax_refs, method)
    Vj = Vc.reshape(4, 3, 4, 3).copy()
    for i, V in enumerate(Vo.reshape(4, 3, 3)):
        Vj[i, :, i, :] += V
    got = T.triangulate(scene[1], models, device="cpu",
                        method=getattr(T, "triangulate_" + method),
                        q_calibration_stdev=0.3, q_observation_stdev=0.2,
                        stabilize_coords=False)
    _close(got[0], p, P_TOL)
    for g, w in zip(got[1:], (Vc, Vo, Vj.reshape(Vc.shape))):
        _close(g, w, COV_TOL)


def test_zero_stdev_gives_zeros(jax_refs, scene, models):
    want = _ref(jax_refs, "raises")["zero"]
    got = T.triangulate(scene[1], models, device="cpu",
                        q_calibration_stdev=0, q_observation_stdev=0)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g in got[1:]:
        assert not g.any()
    _close(got[0], _ref(jax_refs, "raises")["p"], P_TOL)


RAISES = ("negative calibration stdev", "negative observation stdev",
          "lindstrom with a stdev", "no optimization_inputs", "moving camera")


@pytest.mark.parametrize("what", RAISES)
def test_raises_as_jax(jax_refs, scene, what):
    assert _ref(jax_refs, "raises")["raised"][what]
    with pytest.raises(Exception):
        raising_calls(T, *scene, device="cpu")[what]()


def test_unknown_method_raises(scene, models):
    with pytest.raises(ValueError, match="Unknown triangulation method"):
        T.triangulate(scene[1], models, device="cpu", method=len)


def test_lindstrom_matches_jax(jax_refs, scene, models):
    got = T.triangulate(scene[1], models, device="cpu",
                        method=T.triangulate_lindstrom)
    _close(got, _ref(jax_refs, "raises")["lindstrom"], P_TOL)
    _close(got, P_TRUE, 1e-6)


def test_unproject_linear_has_the_unprojection_gradients(models):
    """_unproject_linear is unproject_core at its point, and torch.func
    differentiates it to the implicit function theorem's gradients that
    unproject(get_gradients=True) gives."""
    from mrcal_tpu_torch import triangulation as tri
    from mrcal_tpu_torch.lensmodels import parse_lensmodel
    lens, intr = models[1].intrinsics()
    lm = parse_lensmodel(lens)
    intr = torch.as_tensor(intr)
    q = torch.tensor([[100., 200.], [400., 300.], [700., 550.]],
                     dtype=torch.float64)
    lin = tri._linearization(q, intr, lm)
    v, dv_dq, dv_di = T.unproject(q, lens, intr, get_gradients=True,
                                  device="cpu")
    assert torch.equal(tri._unproject_linear(q, intr, lin, lm), v)
    Jq = torch.func.vmap(torch.func.jacfwd(
        lambda q1, l1: tri._unproject_linear(q1, intr, l1, lm)),
        in_dims=(0, (None, 0, 0, 0)))(q, lin)
    Ji = torch.func.jacfwd(
        lambda i: tri._unproject_linear(q, i, lin, lm))(intr)
    _close(Jq, dv_dq, 1e-12)
    _close(Ji, dv_di, 1e-12)


def test_calibration_noise_takes_the_solve_intrinsics(scene, models):
    """Var_p_calibration is that of the solve's intrinsics, as the JAX
    package's is, also for a model whose intrinsics were changed after
    the solve: the unprojections of dp/db are linearized there anew, not
    at the model's intrinsics that p and Var_p_observation take."""
    oi, q = scene
    moved = [T.cameramodel(optimization_inputs=oi, icam_intrinsics=i)
             for i in (0, 1)]
    lens, intr = moved[0].intrinsics()
    moved[0].intrinsics((lens, intr * np.r_[1.01, 1.01,
                                            np.ones(len(intr) - 2)]))
    p, Vc, Vo, _ = T.triangulate(q, models, device="cpu",
                                 q_calibration_stdev=0.3,
                                 q_observation_stdev=0.2)
    p_moved, Vc_moved, Vo_moved, _ = T.triangulate(
        q, moved, device="cpu", q_calibration_stdev=0.3,
        q_observation_stdev=0.2)
    _close(Vc_moved, Vc, 1e-12)
    assert np.abs((p_moved - p).numpy()).max() > 1e-3
    assert np.abs((Vo_moved - Vo).numpy()).max() > 1e-3 * np.abs(
        Vo.numpy()).max()
