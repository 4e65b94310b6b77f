"""The port's cameramodel and model diffs against the JAX package, in
float64 on the CPU:

  - .cameramodel files written by either package read back in the other
    with the same arrays (optimization_inputs included), and the same
    text; the OpenCV/ROS yaml reader;
  - projection_diff for 2 and 3 models, with and without uncertainties,
    at infinity and at 1 m, with intrinsics_only, a given implied_Rt10
    and focus_center; stereo_pair_diff; model_resolution__deg_pixel;
    is_within_valid_intrinsics_region (against matplotlib's Path, on
    points off the polygon's edges).

Tolerances: difflen to 1e-8 px wherever the implied transform is a
Procrustes fit (at infinity) or given; at 1 m the fit is a damped
least-squares problem whose valley (rotation against translation) is flat
to roundoff, so its answer is defined only to where the stop rules end it
(the two packages compute th2 with different roundoff).  There the port's
fit must reach the JAX package's fit cost (1e-9 relative), and difflen is
held to FIT_DIFFLEN_TOL.

The JAX references run in two processes, started before the first
test."""

import io
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

import mrcal_tpu_torch
from mrcal_tpu_torch import problems

from test_torch_residuals import share_jax_evaluations
from test_torch_residuals import torch_threads  # noqa: F401

SPLINED = "LENSMODEL_SPLINED_STEREOGRAPHIC_order=3_Nx=9_Ny=7_fov_x_deg=120"
DIFF_TOL = 1e-8                    # px
FIT_DIFFLEN_TOL = 1e-4             # px, at 1 m (see the module docstring)
FIT_COST_RTOL = 1e-9
GRID = 10                          # gridn_width of the diffs


def diff_models_oi():
    """Three solves' optimization_inputs of one camera: a 1-camera
    OPENCV4 board problem, and two with their intrinsics and geometry
    perturbed from a seed."""
    oi = problems.make_problem(Ncameras=1, Nframes=6,
                               model="LENSMODEL_OPENCV4", W=6, H=5,
                               device="cpu")[0]
    out = [oi]
    rng = np.random.default_rng(5)
    for seed in (3, 4):
        o = problems.perturbed_oi(oi, seed=seed)
        o["intrinsics"] = oi["intrinsics"] * (
            1 + rng.normal(0, 3e-3, oi["intrinsics"].shape))
        o["intrinsics"][:, 4:] += rng.normal(0, 3e-3, (1, 4))
        out.append(o)
    return out


# name -> (models (indices into diff_models_oi), keyword arguments)
DIFFS = {
    "2 at infinity": ((0, 1), {}),
    "2 at infinity, uncertainties": ((0, 1), dict(use_uncertainties=True)),
    "2 at 1 m": ((0, 1), dict(distance=1.0)),
    "2 at 1 m, uncertainties": ((0, 1), dict(distance=1.0,
                                             use_uncertainties=True)),
    "2 at 1 m, intrinsics only": ((0, 1), dict(distance=1.0,
                                               intrinsics_only=True)),
    "2 at 1 m, implied_Rt10 given": ((0, 1), dict(
        distance=1.0, implied_Rt10=np.array(
            [[1.0, 1e-3, 0], [-1e-3, 1.0, 0], [0, 0, 1.0],
             [0.01, -0.02, 0.005]]))),
    "2 at infinity, focus": ((0, 1), dict(focus_center=(300.0, 200.0),
                                          focus_radius=250.0)),
    "3 at infinity": ((0, 1, 2), {}),
    "3 at infinity, uncertainties": ((0, 1, 2),
                                     dict(use_uncertainties=True)),
    "3 at 1 m": ((0, 1, 2), dict(distance=1.0)),
}
FITTED_AT_1M = ("2 at 1 m", "2 at 1 m, uncertainties", "3 at 1 m")


def _models(pkg):
    return [pkg.cameramodel(optimization_inputs=oi, icam_intrinsics=0)
            for oi in diff_models_oi()]


def _np_out(out):
    return tuple(None if a is None else np.asarray(a) for a in out)


def _jax_refs(part):
    """The JAX package in a fresh process.  "diff": projection_diff for
    every DIFFS case.  "other": stereo_pair_diff and
    model_resolution__deg_pixel."""
    import mrcal_tpu
    share_jax_evaluations()
    ms = _models(mrcal_tpu)
    if part == "diff":
        return {name: _np_out(mrcal_tpu.projection_diff(
            [ms[i] for i in idx], gridn_width=GRID, **kw))
            for name, (idx, kw) in DIFFS.items()}
    out = {}
    for distance in (None, 2.0):
        out["stereo", distance] = _np_out(mrcal_tpu.stereo_pair_diff(
            [(ms[0], _shifted(mrcal_tpu, ms[1])),
             (ms[0], _shifted(mrcal_tpu, ms[2]))], gridn_width=GRID,
            distance=distance))
    for name, m in resolution_models(mrcal_tpu).items():
        out["resolution", name] = np.asarray(
            mrcal_tpu.model_resolution__deg_pixel(m, gridn_width=GRID))
    return out


def _shifted(pkg, m):
    """m as the second camera of a stereo pair, 0.2 m to the right."""
    m = pkg.cameramodel(m)
    m.extrinsics_rt_fromref(np.array([0.01, -0.02, 0.005, -0.2, 0.0, 0.01]))
    return m


def resolution_models(pkg):
    rng = np.random.default_rng(6)
    return {
        "LENSMODEL_OPENCV4": pkg.cameramodel(
            intrinsics=("LENSMODEL_OPENCV4",
                        [750., 748., 399.5, 299.5, -0.05, 0.02, 1e-3, 2e-3]),
            imagersize=(800, 600)),
        "LENSMODEL_LONLAT": pkg.cameramodel(
            intrinsics=("LENSMODEL_LONLAT", [300., 310., 399.5, 299.5]),
            imagersize=(800, 600)),
        SPLINED: pkg.cameramodel(
            intrinsics=(SPLINED, np.concatenate(
                [[400., 400., 399.5, 299.5], rng.normal(size=126) * 0.01])),
            imagersize=(800, 600)),
    }


@pytest.fixture(scope="module")
def jax_refs():
    with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        futures = {part: pool.submit(_jax_refs, part)
                   for part in ("diff", "other")}
        yield futures


def _close(a, b, tol, rel=False):
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = np.abs(b).max() if rel else 1.0
    assert np.abs(a - b).max() <= tol * scale, np.abs(a - b).max()


# ----------------------------------------------------------------------------
# the file format
# ----------------------------------------------------------------------------

def _full_model(pkg):
    """A model from a solve, with a valid-intrinsics region and a pose."""
    oi = diff_models_oi()[1]
    m = pkg.cameramodel(optimization_inputs=oi, icam_intrinsics=0)
    m.valid_intrinsics_region(np.array([[10., 20.], [700., 30.],
                                        [650., 560.], [40., 500.],
                                        [10., 20.]]))
    m.extrinsics_rt_fromref(np.array([0.1, -0.2, 0.03, 0.5, -0.1, 2.0]))
    return m


def _same_model(a, b):
    assert a.intrinsics()[0] == b.intrinsics()[0]
    np.testing.assert_array_equal(a.intrinsics()[1], b.intrinsics()[1])
    np.testing.assert_array_equal(a.imagersize(), b.imagersize())
    np.testing.assert_array_equal(a.extrinsics_rt_fromref(),
                                  b.extrinsics_rt_fromref())
    np.testing.assert_array_equal(a.valid_intrinsics_region(),
                                  b.valid_intrinsics_region())
    assert a.icam_intrinsics() == b.icam_intrinsics()
    assert a.icam_extrinsics() == b.icam_extrinsics()
    oa, ob = a.optimization_inputs(), b.optimization_inputs()
    assert (oa is None) == (ob is None)
    if oa is not None:
        assert set(oa) == set(ob)
        for k in oa:
            if isinstance(oa[k], np.ndarray):
                np.testing.assert_array_equal(oa[k], ob[k], err_msg=k)
            else:
                assert oa[k] == ob[k], k


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cameramodel_file_round_trip(writer):
    """A model written by one package reads in both with the same arrays
    (the optimization_inputs bit for bit), and writes back the same
    text."""
    import mrcal_tpu
    pkgs = dict(jax=mrcal_tpu, port=mrcal_tpu_torch)
    f = io.StringIO()
    _full_model(pkgs[writer]).write(f)
    text = f.getvalue()
    back = {name: pkg.cameramodel(io.StringIO(text))
            for name, pkg in pkgs.items()}
    _same_model(back["port"], back["jax"])
    np.testing.assert_array_equal(
        back["port"].optimization_inputs()["intrinsics"],
        diff_models_oi()[1]["intrinsics"])
    for m in back.values():
        assert str(m) == text


def test_cameramodel_accessors_match_jax():
    import mrcal_tpu
    mj, mt = (pkg.cameramodel(
        intrinsics=("LENSMODEL_OPENCV4", [750., 748., 399.5, 299.5, -0.05,
                                          0.02, 1e-3, 2e-3]),
        imagersize=(800, 600),
        extrinsics_Rt_toref=np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0],
                                      [0.0, 0.0, 1.0], [1.0, 2.0, 3.0]]))
        for pkg in (mrcal_tpu, mrcal_tpu_torch))
    for name in ("extrinsics_rt_fromref", "extrinsics_rt_toref",
                 "extrinsics_Rt_fromref", "extrinsics_Rt_toref"):
        np.testing.assert_allclose(getattr(mt, name)(),
                                   np.asarray(getattr(mj, name)()),
                                   rtol=0, atol=1e-12, err_msg=name)
    mt.extrinsics_Rt_toref(mj.extrinsics_Rt_toref())
    np.testing.assert_allclose(mt.extrinsics_rt_fromref(),
                               mj.extrinsics_rt_fromref(), atol=1e-12)
    # the .cahvor format (once refused): the JAX package's lines, their
    # numbers to roundoff (this rotation by 90 degrees leaves ~1e-13 in
    # entries of H and V that are 0; tests/test_torch_cahvor.py compares
    # bytes), and a model that reads back
    ft, fj = io.StringIO(), io.StringIO()
    mt.write(ft, cahvor=True)
    mj.write(fj, cahvor=True)
    lt, lj = ft.getvalue().splitlines(), fj.getvalue().splitlines()
    assert lt[:2] == lj[:2] == ["Dimensions = 800 600",
                                "Model = CAHV = perspective, linear"]
    assert [l.split(" = ")[0] for l in lt] == [l.split(" = ")[0] for l in lj]
    np.testing.assert_allclose(
        [[float(x) for x in l.split(" = ")[1].split()] for l in lt[2:]],
        [[float(x) for x in l.split(" = ")[1].split()] for l in lj[2:]],
        rtol=0, atol=1e-10)
    back = mrcal_tpu_torch.cameramodel(io.StringIO(ft.getvalue()))
    np.testing.assert_allclose(back.intrinsics()[1], [750., 748., 399.5,
                                                      299.5], atol=1e-9)
    np.testing.assert_allclose(back.extrinsics_rt_fromref(),
                               mt.extrinsics_rt_fromref(), atol=1e-10)


OPENCV_YAML = """image_width: 1280
image_height: 1024
camera_name: cam
camera_matrix:
  rows: 3
  cols: 3
  data: [1000.5, 0, 640.2, 0, 1001.5, 511.8, 0, 0, 1]
distortion_model: plumb_bob
distortion_coefficients:
  rows: 1
  cols: 5
  data: [-0.1, 0.05, 0.001, -0.002, 0.01]
rectification_matrix:
  rows: 3
  cols: 3
  data: [0.9998, -0.0175, 0, 0.0175, 0.9998, 0, 0, 0, 1]
projection_matrix:
  rows: 3
  cols: 4
  data: [1000.5, 0, 640.2, -120.06, 0, 1001.5, 511.8, 0, 0, 0, 1, 0]
"""


def test_opencv_yaml_matches_jax():
    import mrcal_tpu
    mj = mrcal_tpu.cameramodel(io.StringIO(OPENCV_YAML))
    mt = mrcal_tpu_torch.cameramodel(io.StringIO(OPENCV_YAML))
    assert mt.intrinsics()[0] == mj.intrinsics()[0] == "LENSMODEL_OPENCV5"
    np.testing.assert_array_equal(mt.intrinsics()[1], mj.intrinsics()[1])
    np.testing.assert_array_equal(mt.imagersize(), mj.imagersize())
    np.testing.assert_allclose(mt.extrinsics_rt_fromref(),
                               mj.extrinsics_rt_fromref(), atol=1e-12)
    with pytest.raises(Exception, match="Couldn't parse"):
        mrcal_tpu_torch.cameramodel(io.StringIO("not a model"))


# ----------------------------------------------------------------------------
# diffs
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_models():
    return _models(mrcal_tpu_torch)


def _fit_cost(Rt10, q0, models, kw):
    """The 1 m fit's objective at Rt10, as both packages define it, with
    the unit-vector difference for th2 (no cancellation)."""
    m0, m1 = models
    p0 = mrcal_tpu_torch.unproject(q0, *m0.intrinsics(), normalize=True,
                                   device="cpu").numpy().reshape(-1, 3)
    v1 = mrcal_tpu_torch.unproject(q0, *m1.intrinsics(), normalize=True,
                                   device="cpu").numpy().reshape(-1, 3)
    w = np.ones(len(p0))
    if kw.get("use_uncertainties"):
        s0, s1 = (mrcal_tpu_torch.projection_uncertainty(
            v, m, what="worstdirection-stdev", device="cpu").numpy()
            for v, m in ((p0, m0), (v1, m1)))
        w = (1.0 / (s0 * s1)) ** 2
    w = np.minimum(w / (np.sum(w) / np.sum(w > 0)), 1e3)
    p = p0 @ Rt10[:3].T + Rt10[3]
    th2 = np.sum((p / np.linalg.norm(p, axis=-1, keepdims=True) - v1) ** 2,
                 axis=-1)
    f_scale = (5.0 * np.pi / 180.0) ** 2
    w_h = w * np.minimum(1.0, f_scale / np.abs(th2)) ** 0.5
    return np.sum((th2 * w_h) ** 2)


@pytest.mark.parametrize("name", DIFFS)
def test_projection_diff_matches_jax(jax_refs, port_models, name):
    idx, kw = DIFFS[name]
    want = jax_refs["diff"].result(timeout=600)[name]
    got = _np_out(mrcal_tpu_torch.projection_diff(
        [port_models[i] for i in idx], gridn_width=GRID, device="cpu", **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.shape == w.shape
    difflen, _, q0, Rt10 = got
    _close(q0, want[2], 0)
    if name not in FITTED_AT_1M:
        _close(difflen, want[0], DIFF_TOL)
        _close(Rt10, want[3], 1e-9)
        if got[1] is not None:
            _close(got[1], want[1], DIFF_TOL)
        return
    _close(difflen, want[0], FIT_DIFFLEN_TOL)
    for i, (Rt_t, Rt_j) in enumerate(zip(Rt10.reshape(-1, 4, 3),
                                         want[3].reshape(-1, 4, 3))):
        pair = [port_models[idx[0]], port_models[idx[i + 1]]]
        cost_t = _fit_cost(Rt_t, q0, pair, kw)
        cost_j = _fit_cost(Rt_j, q0, pair, kw)
        assert cost_t <= cost_j * (1 + FIT_COST_RTOL), (cost_t, cost_j)


@pytest.mark.parametrize("distance", [None, 2.0])
def test_stereo_pair_diff_matches_jax(jax_refs, port_models, distance):
    m = port_models
    got = mrcal_tpu_torch.stereo_pair_diff(
        [(m[0], _shifted(mrcal_tpu_torch, m[1])),
         (m[0], _shifted(mrcal_tpu_torch, m[2]))], gridn_width=GRID,
        distance=distance, device="cpu")
    for g, w in zip(_np_out(got),
                    jax_refs["other"].result(timeout=600)["stereo",
                                                          distance]):
        _close(g, w, DIFF_TOL)


@pytest.mark.parametrize("name", list(resolution_models(mrcal_tpu_torch)))
def test_model_resolution_matches_jax(jax_refs, name):
    got = mrcal_tpu_torch.model_resolution__deg_pixel(
        resolution_models(mrcal_tpu_torch)[name], gridn_width=GRID,
        device="cpu")
    _close(got, jax_refs["other"].result(timeout=600)["resolution", name],
           1e-10, rel=True)


def test_is_within_valid_intrinsics_region_matches_matplotlib():
    """An even-odd test against matplotlib's Path (the JAX package's), on
    points at least 0.1 px off the region's edges, for a convex and a
    concave region, closed or not; None without a region."""
    import mrcal_tpu
    from matplotlib.path import Path
    rng = np.random.default_rng(7)
    q = rng.uniform(-50, 850, size=(40, 50, 2))
    regions = [np.array([[10., 20.], [700., 30.], [650., 560.],
                         [40., 500.], [10., 20.]]),
               np.array([[100., 100.], [700., 100.], [400., 300.],
                         [700., 500.], [100., 500.]])]
    for region in regions:
        seg0, seg1 = region, np.roll(region, -1, axis=0)
        d = seg1 - seg0
        t = np.clip(np.einsum("...ij,ij->...i", q[..., None, :] - seg0, d)
                    / np.maximum(np.sum(d * d, axis=-1), 1e-30), 0, 1)
        dist = np.linalg.norm(q[..., None, :] - (seg0 + t[..., None] * d),
                              axis=-1).min(axis=-1)
        qq = q[dist > 0.1]
        mj, mt = (pkg.cameramodel(intrinsics=("LENSMODEL_PINHOLE",
                                              [500., 500., 399.5, 299.5]),
                                  imagersize=(800, 600),
                                  valid_intrinsics_region=region)
                  for pkg in (mrcal_tpu, mrcal_tpu_torch))
        got = mrcal_tpu_torch.is_within_valid_intrinsics_region(
            qq, mt, device="cpu")
        assert got.dtype == torch.bool
        want = Path(region).contains_points(qq)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            got.numpy(), mrcal_tpu.is_within_valid_intrinsics_region(qq, mj))
        assert 0 < want.sum() < len(qq)
    m = mrcal_tpu_torch.cameramodel(
        intrinsics=("LENSMODEL_PINHOLE", [500., 500., 399.5, 299.5]),
        imagersize=(800, 600))
    assert mrcal_tpu_torch.is_within_valid_intrinsics_region(
        q, m, device="cpu") is None
