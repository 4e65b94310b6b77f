"""The port's calibration module against the JAX package's, on the CPU:

  - the corners.vnl parser (tests/test_seeding.py's file; a path and a
    file-like object; each weight column kind; excluded images);
  - the monocular PnP (with its focal retry), the camera poses, the joint
    frame poses and seed_stereographic on make_scene scenes with 0.2 px of
    noise, within 1e-9 of the JAX package's; the PnP's 20 Gauss-Newton
    steps as 20 batched cholesky_factor_solve calls at (Nobs, 6, 1);
  - traverse_sensor_links, a callback that aborts included;
  - the slice as a whole: two pinhole cameras' 8-bit renders of a board
    (jax_references.slice_images) through each package's detector,
    corners.vnl, compute_chessboard_corners, seed_stereographic, two
    staged optimize() calls and the valid-intrinsics region of camera 0:
    corners 1e-9 px, seed 1e-9, rms 1e-10, b 1e-5, the contour 1e-6 px.

The JAX references run in processes started before the first test
(jax_reference_pool), one per scene.
"""

import io

import numpy as np
import pytest

import mrcal_tpu
import mrcal_tpu_torch
import mrcal_tpu_torch.calibration as tc

from jax_references import (SLICE_BOARD, SLICE_GLOBS, SLICE_IMAGER,
                            SLICE_STAGE1, jax_reference_pool,
                            seeding_references, slice_images,
                            slice_optimization_inputs, slice_references)
from test_torch_residuals import torch_threads  # noqa: F401

SEED_TOL = 1e-9
CORNER_TOL = 1e-9
RMS_RTOL = 1e-10
B_TOL = 1e-5
CONTOUR_TOL = 1e-6

SEEDINGS = ["2cam", "3cam", "retry"]


@pytest.fixture(scope="module")
def jax_refs():
    """name -> a future of the JAX package's references: "slice" and each
    seeding case."""
    with jax_reference_pool(1 + len(SEEDINGS)) as pool:
        refs = dict(slice=pool.submit(slice_references))
        refs.update({n: pool.submit(seeding_references, n)
                     for n in SEEDINGS})
        yield refs


def _ref(jax_refs, name):
    return jax_refs[name].result(timeout=900)


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= tol, np.abs(a - b).max()


FRONT_END = {"image": ("load_image", "save_image", "apply_color_map"),
             "detector": ("chess_response", "find_chessboard_corners",
                          "detect_corners_in_images"),
             "calibration": ("compute_chessboard_corners",
                             "estimate_monocular_calobject_poses_Rt_tocam",
                             "estimate_joint_frame_poses",
                             "seed_stereographic", "traverse_sensor_links")}


@pytest.mark.parametrize("module", sorted(FRONT_END))
def test_front_end_exports_match_jax(module):
    """The top-level names of the JAX package's image, detector and
    calibration modules are the port's modules' functions."""
    import importlib
    port = importlib.import_module(f"mrcal_tpu_torch.{module}")
    for name in FRONT_END[module]:
        assert callable(getattr(mrcal_tpu, name))
        assert getattr(mrcal_tpu_torch, name) is getattr(port, name)


# ----------------------------------------------------------------------------
# corners.vnl
# ----------------------------------------------------------------------------

def _vnl_text():
    """tests/test_seeding.py::test_compute_chessboard_corners_parsing's
    file, with an image without a board and a third camera's image."""
    lines = ["# filename x y level"]
    for frame in range(2):
        for cam in range(2):
            for i in range(3 * 2):
                lines.append(f"frame{frame}-cam{cam}.png "
                             f"{10.0 * i} {5.0 * i} {i % 3}")
    lines += ["frame7-cam0.png - - -", "frame2-cam9.png 1 2 0"]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("kw", [
    dict(), dict(weight_column_kind="weight"),
    dict(weight_column_kind=None),
    dict(exclude_images={"frame1-cam0.png"})])
@pytest.mark.parametrize("source", ["path", "file"])
def test_vnl_parser_matches_jax(tmp_path, source, kw):
    f = tmp_path / "corners.vnl"
    f.write_text(_vnl_text())

    def parse(pkg):
        cache = str(f) if source == "path" else io.StringIO(_vnl_text())
        return pkg.compute_chessboard_corners(
            3, 2, globs_per_camera=("*cam0*", "*cam1*"),
            corners_cache_vnl=cache, **kw)
    obs_t, idx_t, paths_t = parse(mrcal_tpu_torch)
    obs_j, idx_j, paths_j = parse(mrcal_tpu)
    assert np.array_equal(obs_t, obs_j) and np.array_equal(idx_t, idx_j)
    assert idx_t.dtype == idx_j.dtype and paths_t == paths_j
    if not kw:
        assert obs_t.shape == (4, 2, 3, 3)
        assert obs_t[0, 0, :3, 2].tolist() == [1.0, 0.5, 0.25]


def test_corners_vnl_is_what_the_parser_reads():
    det = np.array([[1.5, 2.25, 0.0], [3.0, 4.0, 0.0]])
    text = tc.corners_vnl([("a1.png", det), ("a2.png", None)])
    assert text == ("# filename x y level\na1.png 1.50000 2.25000 0\n"
                    "a1.png 3.00000 4.00000 0\na2.png - - -\n")
    obs, idx, paths = tc.compute_chessboard_corners(
        2, 1, corners_cache_vnl=io.StringIO(text))
    assert paths == ["a1.png"] and np.array_equal(obs[0, 0], np.array(
        [[1.5, 2.25, 1.0], [3.0, 4.0, 1.0]]))


# ----------------------------------------------------------------------------
# seeding
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", SEEDINGS)
def test_monocular_pnp_matches_jax(jax_refs, name):
    scene, refs = _ref(jax_refs, name)
    idx = scene["indices"][:, :2]
    Rt = mrcal_tpu_torch.estimate_monocular_calobject_poses_Rt_tocam(
        idx, scene["observations"], scene["spacing"], refs["models"],
        device="cpu")
    assert isinstance(Rt, np.ndarray)
    _close(Rt, refs["Rt_cf"], SEED_TOL)


def test_pnp_focal_retry_runs(jax_refs):
    """The retry case's first pass misses (rms > 0.02 in normalized
    coords) on some observations and the retry pass takes them: one more
    batched pass of 20 steps, both scales in it."""
    scene, refs = _ref(jax_refs, "retry")
    calls = []
    real = tc.cholesky_factor_solve

    def recording(A, rhs):
        calls.append((tuple(A.shape), tuple(rhs.shape)))
        return real(A, rhs)
    obs = scene["observations"]
    Nobs = len(obs)
    try:
        tc.cholesky_factor_solve = recording
        tc.estimate_monocular_calobject_poses_Rt_tocam(
            scene["indices"][:, :2], obs, scene["spacing"], refs["models"],
            device="cpu")
    finally:
        tc.cholesky_factor_solve = real
    assert calls[:20] == [((Nobs, 6, 6), (Nobs, 6, 1))] * 20
    nretry = calls[20][0][0] // 2
    assert len(calls) == 40 and 1 <= nretry <= Nobs
    assert calls[20:] == [((2 * nretry, 6, 6), (2 * nretry, 6, 1))] * 20


@pytest.mark.parametrize("name", ["2cam", "3cam"])
def test_camera_and_frame_poses_match_jax(jax_refs, name):
    scene, refs = _ref(jax_refs, name)
    idx = scene["indices"][:, :2]
    Nc = scene["imagersizes"].shape[0]
    Rt_cam_ref = tc._estimate_camera_poses(refs["Rt_cf"], idx, Nc,
                                           device="cpu")
    _close(Rt_cam_ref, refs["Rt_cam_ref"], SEED_TOL)
    W, H = scene["observations"].shape[2], scene["observations"].shape[1]
    frames = mrcal_tpu_torch.estimate_joint_frame_poses(
        refs["Rt_cf"], refs["Rt_cam_ref"][1:], idx, W, H, scene["spacing"],
        device="cpu")
    _close(frames, refs["frames"], SEED_TOL)


@pytest.mark.parametrize("name", ["2cam", "3cam"])
def test_seed_stereographic_matches_jax(jax_refs, name):
    scene, refs = _ref(jax_refs, name)
    seed = mrcal_tpu_torch.seed_stereographic(
        scene["imagersizes"], 700.0, scene["indices"][:, :2],
        scene["observations"], scene["spacing"], device="cpu")
    for got, want in zip(seed, refs["seed"]):
        assert isinstance(got, np.ndarray)
        _close(got, want, SEED_TOL)
    # the seed lands near the truth (tests/test_seeding.py's gates)
    assert np.allclose(seed[1][:, 3:], scene["extrinsics_true"][:, 3:],
                       atol=0.15)
    assert np.allclose(seed[2][:, 3:], scene["frames_true"][:, 3:], atol=0.2)


def test_pnp_raises_on_too_few_corners(jax_refs):
    scene, refs = _ref(jax_refs, "2cam")
    obs = scene["observations"].copy()
    obs[3, ..., 2] = -1.0
    obs[3, 0, :5, 2] = 1.0
    with pytest.raises(Exception, match="too few valid corners"):
        tc.estimate_monocular_calobject_poses_Rt_tocam(
            scene["indices"][:, :2], obs, scene["spacing"], refs["models"],
            device="cpu")


def _traversal(pkg, c, abort_after=None):
    seen = []

    def callback(to, frm):
        seen.append((to, frm))
        return abort_after is None or len(seen) < abort_after
    ok = pkg.traverse_sensor_links(connectivity_matrix=c,
                                   callback_sensor_link=callback)
    return ok, seen


def test_traverse_sensor_links_matches_jax():
    c = np.array([[0, 5, 0, 1, 0],
                  [5, 0, 3, 0, 0],
                  [0, 3, 0, 4, 2],
                  [1, 0, 4, 0, 0],
                  [0, 0, 2, 0, 0]])
    for abort_after in (None, 1, 3):
        ok_t, seen_t = _traversal(mrcal_tpu_torch, c, abort_after)
        ok_j, seen_j = _traversal(mrcal_tpu, c, abort_after)
        assert (ok_t, seen_t) == (ok_j, seen_j)
        assert ok_t is (abort_after is None)
        assert len(seen_t) == (4 if abort_after is None else abort_after)
    for bad in (np.zeros((2, 3)), np.array([[0, 1], [2, 0]]), np.eye(2)):
        with pytest.raises(Exception, match="connectivity_matrix"):
            _traversal(mrcal_tpu_torch, bad)


# ----------------------------------------------------------------------------
# the slice: images -> corners -> seed -> two staged solves -> region
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_slice():
    """The port's front end on the slice's images, on the CPU."""
    W, H, spacing = SLICE_BOARD
    images = slice_images()[0]
    out = dict(detections={name: mrcal_tpu_torch.find_chessboard_corners(
        im, W, H, device="cpu") for name, im in images.items()})
    out["vnl"] = tc.corners_vnl(
        (name, None if c is None else np.concatenate(
            [c, np.full((len(c), 1), float(level))], axis=1))
        for name, (c, level) in out["detections"].items())
    obs, idx_fc, paths = mrcal_tpu_torch.compute_chessboard_corners(
        W, H, globs_per_camera=SLICE_GLOBS,
        corners_cache_vnl=io.StringIO(out["vnl"]))
    out["corners"] = (obs, idx_fc, paths)
    seed = mrcal_tpu_torch.seed_stereographic(
        np.tile(np.array(SLICE_IMAGER), (2, 1)), 500.0, idx_fc, obs, spacing,
        device="cpu")
    out["seed"] = seed
    oi = slice_optimization_inputs(obs, idx_fc, seed)
    for stage, extra in (("stage1", SLICE_STAGE1), ("stage2", {})):
        stats = mrcal_tpu_torch.optimize(device="cpu", **dict(oi, **extra))
        out[stage] = dict(rms=stats["rms_reproj_error__pixels"],
                          b=stats["b_packed"],
                          intrinsics=oi["intrinsics"].copy(),
                          extrinsics=oi["extrinsics_rt_fromref"].copy())
    model = mrcal_tpu_torch.cameramodel(optimization_inputs=oi,
                                        icam_intrinsics=0)
    out["region"] = tc._compute_valid_intrinsics_region(model, device="cpu")
    out["images"] = images
    return out


def test_slice_corners_match_jax(jax_refs, port_slice):
    want = _ref(jax_refs, "slice")
    assert list(port_slice["detections"]) == list(want["detections"])
    for name, (c, level) in port_slice["detections"].items():
        c_j, level_j = want["detections"][name]
        assert c is not None and level == level_j
        _close(c, c_j, CORNER_TOL)
    assert port_slice["vnl"] == want["vnl"]
    for got, ref in zip(port_slice["corners"], want["corners"]):
        if isinstance(got, list):
            assert got == ref
        else:
            assert np.array_equal(got, ref)


def test_slice_seed_matches_jax(jax_refs, port_slice):
    want = _ref(jax_refs, "slice")
    for got, ref in zip(port_slice["seed"], want["seed"]):
        _close(got, ref, SEED_TOL)


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_slice_staged_solves_match_jax(jax_refs, port_slice, stage):
    want = _ref(jax_refs, "slice")[stage]
    got = port_slice[stage]
    assert abs(got["rms"] - want["rms"]) <= RMS_RTOL * want["rms"]
    _close(got["b"], want["b"], B_TOL)
    if stage == "stage2":
        # 8-bit renders of pinhole cameras: the corners' noise is their
        # quantization's
        assert got["rms"] < 0.1
        truth = np.array([[520.0, 518.0, 322.0, 236.0],
                          [540.0, 541.0, 316.0, 243.0]])
        assert np.abs(got["intrinsics"][:, :4] - truth).max() < 1.0


def test_slice_valid_intrinsics_region_matches_jax(jax_refs, port_slice):
    want = _ref(jax_refs, "slice")["region"]
    got = port_slice["region"]
    assert len(got) > 4 and np.array_equal(got[0], got[-1])
    _close(got, want, CONTOUR_TOL)


def test_compute_chessboard_corners_detects_image_files(
        jax_refs, port_slice, tmp_path, monkeypatch):
    """Without a corners cache the detector reads the globs' PNG files: the
    JAX package's observations of the same images.  (The files are
    globbed from their directory: the frame number is the first group of
    digits in the path.)"""
    from mrcal_tpu.image import save_image
    for name, im in port_slice["images"].items():
        save_image(str(tmp_path / name), im)
    monkeypatch.chdir(tmp_path)
    W, H, _ = SLICE_BOARD
    obs, idx_fc, paths = mrcal_tpu_torch.compute_chessboard_corners(
        W, H, globs_per_camera=SLICE_GLOBS, device="cpu")
    obs_j, idx_j, paths_j = _ref(jax_refs, "slice")["corners"]
    assert np.array_equal(obs, obs_j) and np.array_equal(idx_fc, idx_j)
    assert paths == paths_j
    with pytest.raises(FileNotFoundError):
        mrcal_tpu_torch.compute_chessboard_corners(
            W, H, globs_per_camera=("none*",), device="cpu")
