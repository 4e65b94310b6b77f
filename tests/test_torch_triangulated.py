"""The port's triangulated-point path against the JAX package, in float64
on the CPU: unprojection, two-view triangulation and the ray-divergence
measurement, the triangulated layout, residuals and normal equations, the
outlier marking, optimize() end to end, and problems.sfm_triangulated()
against the bench's problem.  Also optimizer_callback's x and Jacobian, and
optimize(check_gradient=True), on board, point and triangulated problems;
and the public wrappers' device: the card unless told "cpu".

The triangulated problem is problems.sfm_triangulated() cut to 4 cameras
and 60 points (59 points seen twice or more, 334 pairs, Nstate 18),
perturbed as bench._perturbed_oi(seed=1).

The JAX package computes the ray-divergence measurement's small angle
from 1 - |cos|, which loses digits as 1/angle^2: ~1e-12 absolute at an
angle of 1e-4 rad.  Its own compiled and eager evaluations differ that
much, and so do its E from the normal equations and from the residual
function at one converged state (a few 1e-9 relative in the rms).  The
port computes the same value as a difference of unit vectors, without
the cancellation.  Where a check meets the reference's noise, its
tolerance says so."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mrcal_tpu
from mrcal_tpu import lensmodels as jlens
from mrcal_tpu import triangulation as jtri
from mrcal_tpu.optimize import layout as jlayout
from mrcal_tpu.optimize import residuals as jres
from mrcal_tpu.optimize import solver as jsolver
from mrcal_tpu_torch import R_from_r, convert, problems
from mrcal_tpu_torch import lensmodels as tlens
from mrcal_tpu_torch import poseutils as tpose
from mrcal_tpu_torch import optimize as t_optimize
from mrcal_tpu_torch import optimizer_callback as t_callback
from mrcal_tpu_torch import triangulation as ttri
from mrcal_tpu_torch.optimize import layout as tlayout
from mrcal_tpu_torch.optimize import residuals as tres
from mrcal_tpu_torch.optimize import solver as tsolver

from test_torch_residuals import point_problem_oi
from test_torch_residuals import torch_threads  # noqa: F401

T = torch.as_tensor


def _close(a, b, tol):
    """|a - b| <= tol * max(1, max|b|), NaN where the other is NaN."""
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(b)
    if ok.any():
        scale = max(1.0, float(np.abs(b[ok]).max()))
        assert np.abs(a[ok] - b[ok]).max() <= tol * scale, \
            np.abs(a[ok] - b[ok]).max()


def tri_oi():
    return problems.perturbed_oi(
        problems.sfm_triangulated(Ncameras=4, Npoints=60), seed=1)


# ----------------------------------------------------------------------------
# unprojection
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["LENSMODEL_PINHOLE",
                                   "LENSMODEL_STEREOGRAPHIC",
                                   "LENSMODEL_LONLAT", "LENSMODEL_LATLON",
                                   "LENSMODEL_OPENCV8"])
def test_unproject_core_matches_jax(model):
    """Pixels of points in view, two cameras: the closed forms, and the
    Gauss-Newton inverse of OPENCV8, at 1e-10."""
    rng = np.random.default_rng(11)
    n = jlens.lensmodel_num_params(model)
    intr = np.array([[800., 780., 799.5, 499.5], [760., 770., 810., 490.]])
    if n > 4:
        dist = np.array([-0.05, 0.02, 1e-3, -1e-3, 5e-3, 1e-3, -1e-3, 1e-3])
        intr = np.concatenate([intr, np.tile(dist, (2, 1))], axis=1)
    p = np.stack([rng.uniform(-3, 3, 40), rng.uniform(-2, 2, 40),
                  rng.uniform(4, 10, 40)], axis=-1)
    q = tlens.project_core(T(p), T(intr[:, None, :]), model)   # (2,40,2)
    v_t = tlens.unproject_core(q, T(intr[:, None, :]), model)
    v_j = jax.jit(lambda q_, i_: jlens.unproject_core(q_, i_, model))(
        q.numpy(), intr[:, None, :])
    _close(v_t.numpy(), v_j, 1e-10)
    # and it is the inverse of the projection
    _close(tlens.project_core(v_t, T(intr[:, None, :]), model).numpy(),
           q.numpy(), 1e-9)


# ----------------------------------------------------------------------------
# two-view triangulation
# ----------------------------------------------------------------------------

TRI_METHODS = ["geometric", "leecivera_l1", "leecivera_linf",
               "leecivera_mid2", "leecivera_wmid2"]
PLANTED = 3      # rows 0-2 fail (see _rays)


def _rays():
    """32 rays to points ~8 m out from two cameras 1 m apart, in camera-0
    coordinates (v0, v1, t01), and in the cameras' own coordinates with
    Rt01 (for Lindstrom and v_are_local).  The first rows fail."""
    rng = np.random.default_rng(4)
    N = 32
    p = rng.normal(size=(N, 3)) * [2.0, 1.0, 1.0] + [0.0, 0.0, 8.0]
    t01 = np.array([1.0, 0.1, -0.2])
    R01 = R_from_r([0.02, -0.1, 0.03], device="cpu").numpy()
    v0 = p + rng.normal(size=(N, 3)) * 0.01
    v1 = p - t01 + rng.normal(size=(N, 3)) * 0.01
    v1[0] = -v1[0]                 # diverging rays
    v0[1], v1[1] = -v0[1], -v1[1]  # a point behind both cameras
    v0[2] = -v0[2]                 # a point behind camera 0
    v1_local = v1 @ R01            # R01 v1_local = v1
    Rt01 = np.concatenate([R01, t01[None]], axis=0)
    return v0, v1, t01, v1_local, Rt01


@pytest.fixture(scope="module")
def rays_jax():
    v0, v1, t01, v1l, Rt01 = _rays()

    def all_methods(v0, v1, t01, v1l, Rt01):
        out = {m: getattr(jtri, "triangulate_" + m)(v0, v1, t01,
                                                      get_gradients=True)
               for m in TRI_METHODS}
        out["lindstrom"] = jtri.triangulate_lindstrom(v0, v1l, Rt01,
                                                      get_gradients=True)
        out["mid2_local"] = jtri.triangulate_leecivera_mid2(
            v0, v1l, v_are_local=True, Rt01=Rt01)
        out["error"] = jtri._triangulated_error(v0, v1, t01)
        return out

    out = jax.jit(all_methods)(v0, v1, t01, v1l, Rt01)
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("method", TRI_METHODS + ["lindstrom"])
def test_triangulation_matches_jax(rays_jax, method):
    """The point and its Jacobians (v0, v1, t01; Lindstrom: v0, v1, Rt01)
    at 1e-10; the planted failures give (0,0,0) with finite gradients."""
    v0, v1, t01, v1l, Rt01 = (T(a) for a in _rays())
    if method == "lindstrom":
        out = ttri.triangulate_lindstrom(v0, v1l, Rt01, get_gradients=True,
                                         device="cpu")
    else:
        out = getattr(ttri, "triangulate_" + method)(v0, v1, t01,
                                                     get_gradients=True,
                                                     device="cpu")
    assert len(out) == 4
    for a, b in zip(out, rays_jax[method]):
        _close(a.numpy(), b, 1e-10)
    if method != "lindstrom":
        assert (out[0][:PLANTED] == 0).all()
        assert (out[0][PLANTED:].abs().sum(-1) > 0).all()
    assert all(torch.isfinite(g).all() for g in out[1:])


def test_triangulation_local_rays_and_out(rays_jax):
    """v_are_local=True rotates v1 by Rt01; out= writes into the
    caller's arrays."""
    v0, v1, t01, v1l, Rt01 = _rays()
    m = ttri.triangulate_leecivera_mid2(T(v0), T(v1l), v_are_local=True,
                                        Rt01=T(Rt01), device="cpu")
    _close(m.numpy(), rays_jax["mid2_local"], 1e-10)
    out = tuple(np.zeros(s) for s in ((32, 3), (32, 3, 3), (32, 3, 3),
                                      (32, 3, 3)))
    ret = ttri.triangulate_geometric(T(v0), T(v1), T(t01),
                                     get_gradients=True, out=out,
                                     device="cpu")
    assert ret is out
    for a, b in zip(out, rays_jax["geometric"]):
        _close(a, b, 1e-10)


@pytest.mark.parametrize("method", TRI_METHODS + ["lindstrom",
                                                  "rotate_point_R"])
def test_wrappers_run_on_the_card_unless_told(monkeypatch, method):
    """The public wrappers take numpy arrays, as the mrcal API is called,
    and run where device says: device="cpu" gives float64 CPU tensors
    equal to the core function's on CPU tensors; no device means the CUDA
    card, and without one they raise rather than fall back to the CPU."""
    v0, v1, t01, v1l, Rt01 = _rays()
    if method == "rotate_point_R":
        args = (Rt01[:3], v1l)
        wrapper = tpose.rotate_point_R
        want = tpose._rotate_point_R(T(Rt01[:3]), T(v1l))
    elif method == "lindstrom":
        args = (v0, v1l, Rt01)
        wrapper, want = ttri.triangulate_lindstrom, \
            ttri._lindstrom(T(v0), T(v1l), T(Rt01))
    else:
        args = (v0, v1, t01)
        wrapper = getattr(ttri, "triangulate_" + method)
        want = getattr(ttri, "_" + method)(T(v0), T(v1), T(t01))
    got = wrapper(*args, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float64
    assert torch.equal(got, want)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        wrapper(*args)


def test_triangulated_error_matches_jax(rays_jax):
    v0, v1, t01, _, _ = (T(a) for a in _rays())
    _close(ttri._triangulated_error(v0, v1, t01).numpy(), rays_jax["error"],
           1e-10)


@pytest.mark.parametrize("th", [1e-2, 1e-3, 1e-4, 1e-5, 1e-6])
def test_angle_error_small_accuracy(th):
    """The small-angle error 2 sin(th/2) of 64 ray pairs at angle th
    (lengths 0.5-20, half of them reversed), against its value in long
    double.  The port's |u0 - s u1| is within 2 eps/th relative (measured
    0.26-0.42); the JAX package's sqrt(2 - 2|cos th|) is the same value
    within its cancellation, 4 eps/th^2 (measured 1.0-1.5): 2e-8 at the
    1e-4 rad of a converged sfm_triangulated solve."""
    rng = np.random.default_rng(5)
    N = 64
    R = R_from_r(rng.normal(size=(N, 3)), device="cpu").numpy()
    ray1 = np.stack([np.full(N, np.sin(th)), np.zeros(N),
                     np.full(N, np.cos(th))], axis=-1)
    v0 = R[:, :, 2] * rng.uniform(0.5, 20, (N, 1))
    v1 = np.einsum("nij,nj->ni", R, ray1) * (rng.uniform(0.5, 20, (N, 1))
                                             * np.where(np.arange(N) % 2,
                                                        -1.0, 1.0)[:, None])
    L0, L1 = v0.astype(np.longdouble), v1.astype(np.longdouble)
    c = np.sqrt(np.sum(np.cross(L0, L1) ** 2, axis=-1))
    exact = 2 * np.sin(np.arctan2(c, np.abs(np.sum(L0 * L1, axis=-1))) / 2)
    eps = np.finfo(np.float64).eps
    port = ttri._angle_error_small(T(v0), T(v1)).numpy()
    ref = np.asarray(jtri._angle_error_small(v0, v1))
    assert float(np.max(np.abs(port - exact) / exact)) <= 2 * eps / th
    assert float(np.max(np.abs(ref - exact) / exact)) <= 4 * eps / th ** 2


# ----------------------------------------------------------------------------
# layout, residuals, normal equations
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tri():
    """The small triangulated problem on both sides; observation 7 marked
    an outlier, so masked pairs are exercised too; with the JAX package's
    normal equations, and its residuals and Jacobian (_jax_x_J)."""
    oi = tri_oi()
    oi["observations_point_triangulated"][7, 2] = -1.0
    spec = jlayout.spec_from_inputs(**oi)
    arrays = jres.arrays_from_inputs(**oi)
    b0 = np.asarray(jres.pack_params(jres.params_from_arrays(arrays), spec))
    tspec, tarrays, tb0 = convert.from_reference(oi, b0, device="cpu")
    static_idx = dict(board=np.zeros((0, 3), np.int32),
                      point=np.zeros((0, 3), np.int32))
    ne = jax.jit(jsolver.build_normal_equations(spec, arrays, static_idx))(
        jnp.asarray(b0), arrays)
    return dict(oi=oi, spec=spec, arrays=arrays, b0=b0, tspec=tspec,
                tarrays=tarrays, tb0=tb0, static_idx=static_idx,
                ne={k: np.asarray(v) for k, v in ne.items()},
                x_J=_jax_x_J(oi))


def _x_J(b, arrays, spec):
    return (jres.residuals_from_packed(b, arrays, spec),
            jax.jacfwd(lambda c: jres.residuals_from_packed(c, arrays, spec))(
                b))


def _jax_x_J(oi):
    """The JAX package's packed state, residuals and forward-mode
    Jacobian on a problem."""
    spec = jlayout.spec_from_inputs(**oi)
    arrays = jres.arrays_from_inputs(**oi)
    b = np.asarray(jres.pack_params(jres.params_from_arrays(arrays), spec))
    x, J = jax.jit(lambda bb: _x_J(bb, arrays, spec))(b)
    return spec, b, np.asarray(x), np.asarray(J)


def test_triangulated_layout_matches_jax(tri):
    oi, spec, tspec = tri["oi"], tri["spec"], tri["tspec"]
    assert tspec.triangulated_set_sizes == spec.triangulated_set_sizes
    assert len(spec.triangulated_set_sizes) == 59
    for attr in ("Nstate", "Nmeasurements",
                 "num_measurements_points_triangulated",
                 "measurement_index_points_triangulated0",
                 "measurement_index_regularization0"):
        assert getattr(tspec, attr) == getattr(spec, attr), attr
    assert tspec.num_measurements_points_triangulated == 334
    for name in ("num_measurements_points_triangulated",
                 "measurement_index_regularization",
                 "decode_observation_indices_points_triangulated"):
        assert getattr(tlayout, name)(**oi) == getattr(jlayout, name)(**oi)
    for i in (0, 1, 20, 59):
        assert tlayout.measurement_index_points_triangulated(i, **oi) == \
            jlayout.measurement_index_points_triangulated(i, **oi)
    for a, b in zip(tlayout.triangulated_pair_indices(
            spec.triangulated_set_sizes),
            jlayout.triangulated_pair_indices(spec.triangulated_set_sizes)):
        assert np.array_equal(a, b)


def test_residuals_triangulated_matches_jax(tri):
    """At the perturbed state, with the outlier's pairs at 0: 1e-10 of
    max(1, max|x|) (the measurement's noise is ~1e-11 here).  The JAX
    side is the triangulated slice of its residuals_from_packed."""
    spec, arrays = tri["spec"], tri["arrays"]
    x_j = tri["x_J"][2][spec.measurement_index_points_triangulated0:
                     spec.measurement_index_regularization0]
    x_t = tres.residuals_triangulated(
        tres.split_packed_state(tri["tb0"], tri["tarrays"], tri["tspec"]),
        tri["tarrays"], tri["tspec"])
    _close(x_t.numpy(), np.asarray(x_j), 1e-10)
    assert (x_t.numpy() == 0).sum() == 3        # observation 7's pairs
    _close(tri["tarrays"]["px_triangulated"].numpy(),
           np.asarray(arrays["px_triangulated"]), 1e-14)


def test_normal_equations_triangulated_match_jax(tri):
    ne = tsolver.build_normal_equations(tri["tspec"], tri["tarrays"],
                                        tri["static_idx"])(tri["tb0"],
                                                           tri["tarrays"])
    assert set(ne) == set(tri["ne"])
    for k, v in ne.items():
        _close(v.numpy(), tri["ne"][k], 1e-10)
    assert ne["x_tri"].shape == (334,)


# ----------------------------------------------------------------------------
# outlier marking
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["divergent", "six_sigma", "pooled"])
def test_mark_outliers_triangulated_matches_jax(tri, case):
    """Both _mark_outliers on the same inputs: a reversed ray (its pairs
    triangulate behind the cameras: outliers whatever their residual), a
    pair at 6 sigma of the pairs' residuals, or board residuals 10x the
    pairs' (one variance for both: the pair at 6 sigma of its own now
    lies within 4 of the pooled one).  The same weights flip, and the
    counts agree."""
    spec, tspec = tri["spec"], tri["tspec"]
    rng = np.random.default_rng(8)
    obs = np.array(tri["oi"]["observations_point_triangulated"])
    ext = np.array(tri["oi"]["extrinsics_rt_fromref"])
    px = np.array(tri["arrays"]["px_triangulated"])
    idx = np.array(tri["oi"][
        "indices_point_triangulated_camintrinsics_camextrinsics"])
    x_tri = rng.normal(size=334) * 1e-3
    board = xb = None
    if case == "divergent":
        px[30] = -px[30]
    else:
        x_tri[100] = 6.5e-3
    if case == "pooled":
        H, W = 3, 4
        board_dims = dict(calibration_object_width_n=W,
                          calibration_object_height_n=H,
                          Nobservations_board=5)
        spec = dataclasses.replace(spec, **board_dims)
        tspec = dataclasses.replace(tspec, **board_dims)
        board = np.ones((5, H, W, 3))
        xb = rng.normal(size=(5, H, W, 2)) * 1e-2

    results = []
    for mark, sp in ((jsolver._mark_outliers, spec),
                     (tsolver._mark_outliers, tspec)):
        o = obs.copy()
        bo = None if board is None else board.copy()
        out = mark(sp, bo, None if xb is None else xb.reshape(-1),
                   obs_tri_np=o, x_tri=x_tri, px_tri=px, idx_tri=idx,
                   extrinsics=ext)
        results.append((out, o, bo))
    (out_j, o_j, b_j), (out_t, o_t, b_t) = results
    assert out_t == out_j
    assert np.array_equal(o_t, o_j)
    newly = np.sum(o_t[:, 2] < 0) - np.sum(obs[:, 2] < 0)
    if board is None:
        assert out_t[0] is True and newly >= 2
    else:
        assert np.array_equal(b_t, b_j)
        assert newly == 0


# ----------------------------------------------------------------------------
# optimize() end to end
# ----------------------------------------------------------------------------

def test_optimize_triangulated_matches_jax():
    """The small problem with outlier rejection on and one observation
    moved by 60 px: the JAX package's optimize() (its host loop) and the
    port's reach the same optimum and mark the same observations.  The rms
    is held to 1e-8, above the reference measurement's noise at this
    optimum (see the module docstring); the extrinsics to 1e-6."""
    oi = tri_oi()
    oi["do_apply_outlier_rejection"] = True
    oi["observations_point_triangulated"][40, :2] += (60.0, -20.0)
    oi_j, oi_t = copy.deepcopy(oi), copy.deepcopy(oi)
    s_j = mrcal_tpu.optimize(precision="f64", device_loop=False, **oi_j)
    s_t = t_optimize(device="cpu", **oi_t)
    rms_j = s_j["rms_reproj_error__pixels"]
    assert abs(s_t["rms_reproj_error__pixels"] - rms_j) <= 1e-8 * rms_j
    assert np.abs(oi_t["extrinsics_rt_fromref"]
                  - oi_j["extrinsics_rt_fromref"]).max() <= 1e-6
    assert s_t["Noutliers_triangulated_point"] == \
        s_j["Noutliers_triangulated_point"] > 0
    assert np.array_equal(oi_t["observations_point_triangulated"],
                          oi_j["observations_point_triangulated"])
    assert oi_t["observations_point_triangulated"][40, 2] < 0
    assert s_t["x"].shape == s_j["x"].shape == (335,)


def test_triangulated_solve_ignores_thread_count():
    """With no cancellation noise in the measurement at the optimum, the
    LM loop's accept/reject decisions there do not follow the summation
    order: the small problem solves in the same iterations to the same
    rms (1e-12 relative) at 1 and 4 CPU threads."""
    threads = torch.get_num_threads()
    out = []
    try:
        for n in (1, 4):
            torch.set_num_threads(n)
            s = t_optimize(device="cpu", **tri_oi())
            out.append((s["niterations"], s["rms_reproj_error__pixels"]))
    finally:
        torch.set_num_threads(threads)
    assert out[0][0] == out[1][0]
    assert abs(out[0][1] - out[1][1]) <= 1e-12 * out[1][1]


def test_sfm_triangulated_is_the_bench_configuration():
    """problems.sfm_triangulated() gives bench._sfm_config()'s inputs:
    index arrays exactly, observations to 1e-9."""
    import bench
    oi_j = bench._sfm_config()["oi"]
    oi_t = problems.sfm_triangulated()
    assert set(oi_t) == set(oi_j)
    key = "indices_point_triangulated_camintrinsics_camextrinsics"
    assert np.array_equal(oi_t[key], oi_j[key])
    for k, v in oi_j.items():
        if isinstance(v, np.ndarray):
            assert v.shape == oi_t[k].shape, k
            assert np.allclose(oi_t[k], v, rtol=0, atol=1e-9), k
        else:
            assert oi_t[k] == v, k
    spec = tlayout.spec_from_inputs(**oi_t)
    assert (spec.Nmeasurements, spec.Nstate) == (11443, 42)
    assert (len(spec.triangulated_set_sizes), len(oi_t[key])) == (492, 3527)


# ----------------------------------------------------------------------------
# optimizer_callback and check_gradient
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def callback_oi(tri):
    return dict(board=problems.make_problem(device="cpu")[0],
                point=point_problem_oi(), triangulated=tri["oi"])


@pytest.mark.parametrize("which", ["board", "point", "triangulated"])
def test_optimizer_callback_matches_jax(tri, callback_oi, which):
    """b, x and the dense J against the JAX package's residual function
    and its forward-mode Jacobian, at 1e-10.  The triangulated rows are
    held at 1e-10 where the pair's divergence exceeds 1e-3 rad and at 1e-6
    below it, where the measurement's cancellation leaves ~1e-8 relative
    noise (see the module docstring)."""
    oi = copy.deepcopy(callback_oi[which])
    spec, b, x_j, J_j = (tri["x_J"] if which == "triangulated"
                         else _jax_x_J(oi))

    b_t, x_t, J_t = t_callback(device="cpu", **oi)
    assert J_t.shape == (spec.Nmeasurements, spec.Nstate)
    _close(b_t, b, 1e-14)
    _close(x_t, x_j, 1e-10)
    Jd = J_t.toarray()
    # every nonzero of the full Jacobian lies in the sparse pattern
    coo = J_t.tocoo()
    stored = np.zeros(J_t.shape, bool)
    stored[coo.row, coo.col] = True
    assert not np.any((J_j != 0) & ~stored)
    assert J_t.nnz < 0.6 * J_t.shape[0] * J_t.shape[1]
    i0 = spec.measurement_index_points_triangulated0
    i1 = spec.measurement_index_regularization0
    well = np.ones(len(x_j), bool)
    well[i0:i1] = np.abs(x_j[i0:i1]) > 1e-3
    _close(Jd[well], J_j[well], 1e-10)
    _close(Jd, J_j, 1e-6)
    _, x_nj, J_nj = t_callback(device="cpu", no_jacobian=True, **oi)
    assert J_nj is None and np.array_equal(x_nj, x_t)


@pytest.mark.parametrize("which", ["board", "point", "triangulated"])
def test_optimize_check_gradient(callback_oi, which):
    """optimize(check_gradient=True) compares the Jacobian with central
    differences on every state column and returns without solving.  The
    triangulated measurement's kinks and cancellation leave a larger
    finite-difference error (the JAX package's own test allows 3e-5)."""
    oi = copy.deepcopy(callback_oi[which])
    if which == "board":
        oi = problems.make_problem(Ncameras=2, Nframes=4, W=4, H=3,
                                   device="cpu")[0]
    before = copy.deepcopy(oi)
    s = t_optimize(device="cpu", check_gradient=True, **oi)
    spec = tlayout.spec_from_inputs(**oi)
    assert s["check_gradient"] is True
    assert s["ncols_checked"] == spec.Nstate
    assert 0 <= s["worst_ivar"] < spec.Nstate
    assert s["worst_relative_error"] < (3e-5 if which == "triangulated"
                                        else 1e-5)
    for k, v in before.items():
        if isinstance(v, np.ndarray):
            assert np.array_equal(oi[k], v), k
