"""The port's synthetic_data against the JAX package's, in float64 on the
CPU, each after the same np.random.seed (the random draws are numpy's
global generator in both, in the same order):

  - ref_calibration_object with and without a warp, with a broadcast
    warp, with corner sub-ranges and from optimization_inputs: 1e-15;
  - synthesize_board_observations for each `which` and with
    max_oblique_angle_deg on two OPENCV4 cameras: the same frames kept,
    q within 1e-9 px and Rt_ref_boardref within 1e-12;
  - make_perfect_observations on a board problem and on a point problem:
    1e-9 px, with the same noise;
  - make_tracks: the same indices and points, observations within 1e-9
    px;
  - problems.stereo_opencv8_2cam() at a small size: the JAX tests' scene
    recipe through the JAX package's synthetic functions."""

import numpy as np
import pytest

import mrcal_tpu
import mrcal_tpu.synthetic_data as jsyn
import mrcal_tpu_torch as T
from mrcal_tpu_torch import problems
from mrcal_tpu_torch import synthetic_data as tsyn

from test_calibration import make_scene
from test_torch_residuals import point_problem_oi
from test_torch_residuals import torch_threads  # noqa: F401

PX_TOL = 1e-9
RT_TOL = 1e-12
WARP = np.array([0.002, -0.001])


@pytest.mark.parametrize("kw", [
    dict(), dict(calobject_warp=WARP),
    dict(calobject_warp=np.array([[0.002, -0.001], [0.0, 0.003],
                                  [-0.001, 0.0]])),
    dict(calobject_warp=WARP, x_corner0=1, x_corner1=5, Nx=9, y_corner0=2,
         y_corner1=4, Ny=3)], ids=["flat", "warp", "broadcast", "corners"])
def test_ref_calibration_object_matches_jax(kw):
    got = tsyn.ref_calibration_object(8, 6, 0.077, **kw)
    want = jsyn.ref_calibration_object(8, 6, 0.077, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


def test_ref_calibration_object_of_optimization_inputs():
    oi = problems.make_problem(device="cpu")[0]
    np.testing.assert_allclose(
        tsyn.ref_calibration_object(optimization_inputs=oi),
        jsyn.ref_calibration_object(optimization_inputs=oi), rtol=0,
        atol=1e-15)


def _models(pkg):
    """Two OPENCV4 cameras 0.22 m apart (make_scene's)."""
    intr = [[750., 746.25, 404.5, 295.5, -0.02, 0.01, 1e-3, -1e-3],
            [770., 766.15, 401.5, 297.5, 0.01, -0.01, 0.0, 1e-3]]
    return [pkg.cameramodel(intrinsics=("LENSMODEL_OPENCV4", intr[i]),
                            imagersize=(800, 600),
                            rt_cam_ref=np.array([0.01, -0.02, 0.005, -0.22,
                                                 0.02, 0.01]) * i)
            for i in (0, 1)]


SYNTH = dict(object_width_n=8, object_height_n=6, object_spacing=0.077,
             calobject_warp=WARP,
             rt_ref_boardcenter=np.array([0., 0., 0., 0., 0., 1.2]),
             rt_ref_boardcenter__noiseradius=np.array(
                 [np.pi / 6, np.pi / 6, np.pi / 9, 0.2, 0.2, 0.4]),
             Nframes=10)


@pytest.mark.parametrize("kw", [dict(which=w) for w in tsyn.WHICH]
                         + [dict(max_oblique_angle_deg=30.0)],
                         ids=list(tsyn.WHICH) + ["max_oblique_angle_deg"])
def test_synthesize_board_observations_matches_jax(kw):
    kw = dict(SYNTH, **kw)
    np.random.seed(3)
    q_t, Rt_t = tsyn.synthesize_board_observations(_models(T), device="cpu",
                                                   **kw)
    state_t = np.random.get_state()[1]
    np.random.seed(3)
    q_j, Rt_j = jsyn.synthesize_board_observations(_models(mrcal_tpu), **kw)
    # the same draws, so the same culled set
    assert np.array_equal(np.random.get_state()[1], state_t)
    assert q_t.shape == q_j.shape == (10, 2, 6, 8, 2)
    np.testing.assert_allclose(Rt_t, Rt_j, rtol=0, atol=RT_TOL)
    np.testing.assert_allclose(q_t, q_j, rtol=0, atol=PX_TOL)


def test_synthesize_board_observations_rejects_unknown_which():
    with pytest.raises(Exception, match="'which' must be one of"):
        tsyn.synthesize_board_observations(_models(T), device="cpu",
                                           **dict(SYNTH, which="any"))


@pytest.mark.parametrize("kind", ["board", "point"])
def test_make_perfect_observations_matches_jax(kind):
    # the board problem has the shapes of the other tests' scenes, so the
    # JAX package compiles their operations once
    oi = (problems.stereo_opencv8_2cam(10, "LENSMODEL_OPENCV4", 8, 6,
                                       device="cpu")
          if kind == "board" else point_problem_oi())
    key = f"observations_{kind}"
    got = {k: (v.copy() if isinstance(v, np.ndarray) else v)
           for k, v in oi.items()}
    np.random.seed(7)
    tsyn.make_perfect_observations(got, observed_pixel_uncertainty=0.3,
                                   device="cpu")
    np.random.seed(7)
    jsyn.make_perfect_observations(oi, observed_pixel_uncertainty=0.3)
    np.testing.assert_allclose(got[key], oi[key], rtol=0, atol=PX_TOL)


def test_make_tracks_matches_jax():
    intr = np.array([800., 800., 600., 450.])
    kw = dict(Nobservations_total=200, track_length=4,
              Nobservations_image=40, gridn=8, Npoint_observations_min=2,
              Ncam_observing_min=2)
    obs_t, idx_t, pts_t, Rt_t = tsyn.make_tracks(
        T.cameramodel(intrinsics=("LENSMODEL_PINHOLE", intr),
                      imagersize=(1200, 900)), device="cpu", **kw)
    obs_j, idx_j, pts_j, Rt_j = jsyn.make_tracks(
        mrcal_tpu.cameramodel(intrinsics=("LENSMODEL_PINHOLE", intr),
                              imagersize=(1200, 900)), **kw)
    assert len(obs_t) >= 50
    assert np.array_equal(idx_t, idx_j) and idx_t.dtype == idx_j.dtype
    assert np.array_equal(pts_t, pts_j)
    assert np.array_equal(Rt_t, Rt_j)
    np.testing.assert_allclose(obs_t, obs_j, rtol=0, atol=PX_TOL)


def test_stereo_scene_is_the_jax_recipe():
    """problems.stereo_opencv8_2cam at 10 frames of an 8x6 board: the JAX
    tests' make_scene (true geometry, noiseless q) through the JAX
    package's synthesize_board_observations, then its
    make_perfect_observations's noise and bench._perturbed_oi(seed=1)."""
    import bench
    got = problems.stereo_opencv8_2cam(10, "LENSMODEL_OPENCV4", 8, 6,
                                       device="cpu")
    scene = make_scene(Ncameras=2, Nframes=10, model="LENSMODEL_OPENCV4",
                       W=8, H=6, seed=0, rig_spacing=0.22)
    want = dict(
        intrinsics=scene["intrinsics_true"],
        extrinsics_rt_fromref=scene["extrinsics_true"],
        frames_rt_toref=scene["frames_true"],
        observations_board=scene["observations"],
        indices_frame_camintrinsics_camextrinsics=scene["indices"],
        lensmodel=scene["lensmodel"], imagersizes=scene["imagersizes"],
        calobject_warp=scene["warp"],
        calibration_object_spacing=scene["spacing"])
    jsyn.make_perfect_observations(want, observed_pixel_uncertainty=0.3)
    want = bench._perturbed_oi(want, seed=1)
    want["do_apply_outlier_rejection"] = False
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=PX_TOL,
                                       err_msg=k)
        else:
            assert got[k] == v
