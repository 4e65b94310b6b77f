"""The port's uncertainty path against the JAX package, in float64 on the
CPU, on small problems made from a numpy seed:

  - projection_uncertainty, every method at a finite distance and at
    infinity, on a 1-camera OPENCV4 board problem, a 2-camera one queried
    on camera 1, a discrete-point problem, a 9x7-knot splined one and a
    moving camera (mean-pcam; observed under two extrinsics): covariances
    to 1e-8 of their largest entry, the worstdirection-stdev and rms-stdev
    to 1e-8 relative (against the JAX package's own calls for mean-pcam
    on the 1-camera problem, against its reductions of its covariances
    elsewhere);
  - the sparse propagation path (taken above Nstate 4096, here forced)
    against the JAX package's dense result, at the same tolerance;
  - drt_cross_reprojection__dbpacked, rrp and ccp, the moving camera
    included: 1e-9 of its largest entry;
  - CHOLMOD_factorization in every solve mode, dense and sparse, and
    rcond: 1e-10 of the largest entry.

The JAX references cost tens of seconds of compiles per problem (its
eager code compiles each operation for each new shape), so they run in
four processes, all started before the first test, and the pixel noise
is given to both packages (the JAX package then compiles no residual
function of its own) on every problem but the 1-camera one."""


import numpy as np
import pytest
import scipy.sparse
import torch

import mrcal_tpu_torch
from mrcal_tpu_torch import model_analysis as tma
from mrcal_tpu_torch import problems
from mrcal_tpu_torch.optimize.jacobian import optimizer_callback
from mrcal_tpu_torch.optimize.layout import spec_from_inputs

from jax_references import residuals_cross_cases, uncertainty_references
from test_torch_residuals import jax_reference_pool, point_problem_oi
from test_torch_residuals import torch_threads  # noqa: F401

SPLINED = "LENSMODEL_SPLINED_STEREOGRAPHIC_order=3_Nx=9_Ny=7_fov_x_deg=120"
METHODS = ("mean-pcam", "cross-reprojection-rrp-Jfp",
           "cross-reprojection-ccp")
COV_TOL = 1e-8
DRT_TOL = 1e-9
FACTOR_TOL = 1e-10
# query points in camera coordinates, with a leading shape of (2, 2)
P_CAM = np.array([[[0.1, -0.05, 1.0], [0.3, 0.2, 2.0]],
                  [[-0.2, 0.1, 1.5], [0.0, 0.0, 3.0]]])


def _moving_oi():
    """Camera 0 observed under extrinsics 0 and 1 (a moving camera);
    camera 1 at the reference."""
    oi = problems.make_problem(Ncameras=3, Nframes=5, model=
                               "LENSMODEL_OPENCV4", W=6, H=5,
                               device="cpu")[0]
    idx = oi["indices_frame_camintrinsics_camextrinsics"]
    idx[:, 1] = np.where(idx[:, 2] < 0, 1, 0)
    oi["intrinsics"] = oi["intrinsics"][:2]
    oi["imagersizes"] = oi["imagersizes"][:2]
    return oi


def _points_oi():
    """The discrete-point problem of test_torch_residuals without its
    variable points seen by one camera only (their depth is not
    observable, and JtJ would be singular)."""
    oi = point_problem_oi()
    idx = oi["indices_point_camintrinsics_camextrinsics"]
    Npts = len(oi["points"])
    seen = np.bincount(idx[:, 0], minlength=Npts)
    keep = (seen >= 2) | (np.arange(Npts) >= Npts - oi["Npoints_fixed"])
    new = np.cumsum(keep) - 1
    rows = keep[idx[:, 0]]
    oi["points"] = oi["points"][keep]
    oi["observations_point"] = oi["observations_point"][rows]
    oi["indices_point_camintrinsics_camextrinsics"] = np.concatenate(
        [new[idx[rows, 0]][:, None], idx[rows, 1:]], axis=1).astype(np.int32)
    return oi


def problem(name):
    """(optimization_inputs, the queried camera, its methods)."""
    if name == "1cam":
        oi = problems.make_problem(Ncameras=1, Nframes=6,
                                   model="LENSMODEL_OPENCV4", W=6, H=5,
                                   device="cpu")[0]
        return oi, 0, METHODS
    if name == "2cam":
        oi = problems.make_problem(Ncameras=2, Nframes=6,
                                   model="LENSMODEL_OPENCV4", W=6, H=5,
                                   device="cpu")[0]
        return oi, 1, METHODS
    if name == "points":
        return _points_oi(), 1, METHODS
    if name == "splined":
        oi = problems.make_problem(Ncameras=1, Nframes=6, model=SPLINED,
                                   W=6, H=5, device="cpu",
                                   do_optimize_intrinsics_core=False)[0]
        return oi, 0, METHODS
    if name == "moving":
        # rrp takes stationary cameras only
        return _moving_oi(), 0, ("mean-pcam", "cross-reprojection-ccp")
    raise ValueError(name)


PROBLEMS = ("1cam", "2cam", "points", "splined", "moving")
CASES = [(name, method, atinfinity) for name in PROBLEMS
         for method in problem(name)[2] for atinfinity in (False, True)]


# the pixel noise given to both packages, but on 1cam, where each
# estimates it from the residuals
SIGMA = {name: None if name == "1cam" else 0.3 for name in PROBLEMS}
# the JAX references' processes: the moving camera rides with the points
CHILDREN = (("1cam",), ("2cam",), ("points", "moving"), ("splined",))


RT_CC = np.array([1e-3, -2e-3, 5e-4, 0.01, -0.02, 0.005])


@pytest.fixture(scope="module")
def jax_refs():
    """Every problem's JAX references, from len(CHILDREN) processes started
    at once."""
    with jax_reference_pool(len(CHILDREN)) as pool:
        futures = [pool.submit(uncertainty_references, {
            name: problem(name) + (SIGMA[name],) for name in names}, P_CAM,
            RT_CC) for names in CHILDREN]
        yield {name: f for names, f in zip(CHILDREN, futures)
               for name in names}


def _ref(jax_refs, name):
    return jax_refs[name].result(timeout=600)[name]


@pytest.fixture(scope="module")
def models():
    return {name: mrcal_tpu_torch.cameramodel(
        optimization_inputs=problem(name)[0],
        icam_intrinsics=problem(name)[1]) for name in PROBLEMS}


def _close(a, b, tol):
    """|a - b| <= tol * max|b|."""
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= tol * np.abs(b).max(), \
        (np.abs(a - b).max(), np.abs(b).max())


@pytest.mark.parametrize("name,method,atinfinity", CASES)
def test_projection_uncertainty_matches_jax(jax_refs, models, name, method,
                                            atinfinity):
    ref = _ref(jax_refs, name)
    cov = tma.projection_uncertainty(
        P_CAM, models[name], method=method, atinfinity=atinfinity,
        observed_pixel_uncertainty=SIGMA[name], device="cpu")
    assert cov.shape == (2, 2, 2, 2) and cov.dtype == torch.float64
    _close(cov, ref["cov"][method, atinfinity], COV_TOL)
    for what, want in ref["what"][method, atinfinity].items():
        got = tma.projection_uncertainty(
            P_CAM, models[name], method=method, atinfinity=atinfinity,
            what=what, observed_pixel_uncertainty=SIGMA[name],
            device="cpu")
        assert got.shape == (2, 2)
        _close(got, want, COV_TOL)


@pytest.mark.parametrize("method", METHODS)
def test_sparse_path_matches_jax_dense(jax_refs, models, monkeypatch,
                                       method):
    """Above Nstate 4096 J stays sparse and JtJ factors on the host (the
    JAX package's threshold, a literal there); forced here on a small
    problem, against the JAX package's dense result."""
    monkeypatch.setattr(tma, "_DENSE_NSTATE_MAX", 0)
    cov = tma.projection_uncertainty(P_CAM, models["2cam"], method=method,
                                     observed_pixel_uncertainty=0.3,
                                     device="cpu")
    _close(cov, _ref(jax_refs, "2cam")["cov"][method, False], COV_TOL)


@pytest.mark.parametrize("name", PROBLEMS)
def test_drt_cross_reprojection_matches_jax(jax_refs, name):
    oi, icam, _ = problem(name)
    for ic, want in _ref(jax_refs, name)["drt"].items():
        got = mrcal_tpu_torch.drt_cross_reprojection__dbpacked(
            icam_intrinsics=ic, device="cpu", **oi)
        assert isinstance(got, np.ndarray)
        _close(got, want, DRT_TOL)


def test_residuals_cross_matches_jax(jax_refs):
    """Every flavor of residuals_cross, at 1e-12 of the largest entry."""
    got = residuals_cross_cases("port", problem("2cam")[0], RT_CC,
                                lambda t: t.numpy())
    for flavor, want in _ref(jax_refs, "2cam")["residuals_cross"].items():
        _close(got[flavor], want, 1e-12)


def test_observed_pixel_uncertainty_and_propagation_entry():
    """The noise estimate is the rms of the inlier residuals, and the
    propagation entry point takes a given J and x as the reference's
    does."""
    oi = problem("1cam")[0]
    _, x, J = optimizer_callback(device="cpu", **oi)
    spec = spec_from_inputs(**oi)
    xb = x[:spec.num_measurements_boards]
    sigma = tma._observed_pixel_uncertainty_from_inputs(oi, device="cpu")
    assert sigma == pytest.approx(np.sqrt(np.mean(xb * xb)), rel=1e-12)
    dF = np.random.default_rng(0).normal(size=(3, 2, spec.Nstate))
    a = tma._propagate_calibration_uncertainty(
        dF, optimization_inputs=oi, device="cpu")
    b = tma._propagate_calibration_uncertainty(
        dF, x=x, J=J, optimization_inputs=oi, device="cpu")
    Jd = J.toarray()
    A = np.linalg.solve(Jd.T @ Jd, dF.reshape(-1, spec.Nstate).T)
    M = (Jd[:spec.measurement_index_regularization0] @ A).reshape(
        -1, 3, 2)
    want = np.einsum("mia,mib->iab", M, M) * sigma ** 2
    _close(a, want, COV_TOL)
    _close(b, want, COV_TOL)


# ----------------------------------------------------------------------------
# CHOLMOD_factorization
# ----------------------------------------------------------------------------

MODES = ("A", "LDLt", "LD", "DLt", "L", "Lt", "D", "P", "Pt")


@pytest.fixture(scope="module")
def factorization_refs():
    """J of the 2-camera problem (scipy), right-hand sides, and the JAX
    package's solves and rcond, dense and sparse."""
    import mrcal_tpu
    J = optimizer_callback(device="cpu", **problem("2cam")[0])[2]
    bt = np.random.default_rng(1).normal(size=(3, J.shape[1]))
    out = dict(J=J, bt=bt)
    for dense in (True, False):
        f = mrcal_tpu.CHOLMOD_factorization(J, force_dense=dense)
        out[dense] = dict(rcond=f.rcond(),
                          **{m: np.asarray(f.solve_xt_JtJ_bt(bt, mode=m))
                             for m in MODES})
    return out


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "sparse"])
def test_cholmod_factorization_matches_jax(factorization_refs, dense):
    J, bt = factorization_refs["J"], factorization_refs["bt"]
    ref = factorization_refs[dense]
    f = mrcal_tpu_torch.CHOLMOD_factorization(J, force_dense=dense,
                                              device="cpu")
    assert f.rcond() == pytest.approx(ref["rcond"], rel=FACTOR_TOL)
    for mode in MODES:
        got = f.solve_xt_JtJ_bt(bt, mode=mode)
        assert isinstance(got, np.ndarray)
        _close(got, ref[mode], FACTOR_TOL)
        # a tensor in, a tensor out, over any leading dimensions;
        # CHOLMOD_ prefixes and sys= accepted
        got_t = f.solve_xt_JtJ_bt(torch.as_tensor(bt).reshape(3, 1, -1),
                                  sys="CHOLMOD_" + mode)
        assert torch.is_tensor(got_t) and got_t.shape == (3, 1, J.shape[1])
        _close(got_t[:, 0], ref[mode], FACTOR_TOL)


def test_cholmod_factorization_inputs():
    """JtJ given instead of J, a dense J, and a matrix that is not
    positive definite; an unknown mode raises."""
    J = optimizer_callback(device="cpu", **problem("1cam")[0])[2]
    Jd = J.toarray()
    bt = np.random.default_rng(2).normal(size=J.shape[1])
    want = np.linalg.solve(Jd.T @ Jd, bt)
    for f in (mrcal_tpu_torch.CHOLMOD_factorization(JtJ=Jd.T @ Jd,
                                                    device="cpu"),
              mrcal_tpu_torch.CHOLMOD_factorization(Jd, device="cpu"),
              mrcal_tpu_torch.CHOLMOD_factorization(
                  scipy.sparse.csr_matrix(Jd), force_dense=False,
                  device="cpu")):
        _close(f.solve_xt_JtJ_bt(bt), want, FACTOR_TOL)
    with pytest.raises(Exception, match="Unknown solve mode"):
        f.solve_xt_JtJ_bt(bt, mode="X")
    with pytest.raises(Exception, match="not positive definite"):
        mrcal_tpu_torch.CHOLMOD_factorization(JtJ=-np.eye(3), device="cpu")
