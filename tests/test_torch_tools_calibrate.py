"""The port's mrcal-calibrate-cameras (mrcal_tpu_torch.tools.
calibrate_cameras) against the JAX package's script, on the CPU.

A two-camera OPENCV4 scene of 10 frames of an 8 x 6 board (the cameras of
tests/test_calibration.py's make_scene, seed 13), 0.3 px of noise and
three corners moved 25 px, is written to a corners.vnl; each package's
tool calibrates it into its own directory:

  - from --focal, with outlier rejection (which finds the moved corners);
  - the same with --skip-outlier-rejection;
  - from --seed models (the truth with fx and fy 0.2 % off);
  - a one-camera splined model (7 x 5 knots) from --focal, through the
    staged solve that resets fxycxy.

The report lines are held to the JAX script's, word for word and number
for number as printed; the written models by their optimization inputs
(the same outliers; rms 1e-10 relative and b 1e-5, as tests/
test_torch_solver.py holds a solve), their extrinsics (1e-7) and their
projection of a 30 x 22 grid of camera 0's unprojections at 1 m (1e-5
px).  The --explore shell's plots (calibrate_cameras.explore_namespace,
the JAX script's names) on the models of the scene's truth are held to the
JAX package's show_* called as its shell calls them, by tests/
test_torch_visualization.py's comparison of figures (texts equal, arrays
within 1e-8 of their largest entry).  (That every tool's main wants the
card unless told is tests/test_torch_isolation.py's.)

The JAX scripts run in processes started before the first test
(jax_reference_pool), one per case, and one more draws the shell's
plots.
"""

import os
import re

import numpy as np
import pytest

import mrcal_tpu_torch

from jax_references import (jax_reference_pool, run_jax_tools, run_tool,
                            viz_explore_references)
from test_torch_residuals import torch_threads  # noqa: F401
from test_torch_visualization import (  # noqa: F401
    assert_contents_match, saved_figures)

RMS_RTOL = 1e-10
B_TOL = 1e-5
RT_TOL = 1e-7
GRID_PX_TOL = 1e-5
SPLINED = "LENSMODEL_SPLINED_STEREOGRAPHIC_order=3_Nx=7_Ny=5_fov_x_deg=120"


# ----------------------------------------------------------------------------
# scenes, and the comparison of reports and models (the other tool files
# import these)
# ----------------------------------------------------------------------------

def scene_models(Ncameras=2, model="LENSMODEL_OPENCV4", seed=13):
    """make_scene's cameras (tests/test_calibration.py): 800 x 600, fx
    750 + 20 i, small random distortions, camera i 0.22 i m to the left."""
    np.random.seed(seed)
    imagersize = np.array([800, 600])
    models = []
    for i in range(Ncameras):
        fx = 750.0 + 20 * i
        core = [fx, fx * 0.995, (imagersize[0] - 1) / 2 + 5 - 3 * i,
                (imagersize[1] - 1) / 2 - 4 + 2 * i]
        n = mrcal_tpu_torch.lensmodel_num_params(model)
        dist = (np.random.randn(n - 4) * 1e-2).tolist()
        rt = np.zeros(6) if i == 0 else np.array(
            [0.01 * i, -0.02 * i, 0.005 * i, -0.22 * i, 0.02 * i, 0.01 * i])
        models.append(mrcal_tpu_torch.cameramodel(
            intrinsics=(model, np.array(core + dist)), imagersize=imagersize,
            rt_cam_ref=rt))
    return models


def board_observations(models, Nframes, W=8, H=6, spacing=0.077,
                       noise_px=0.3, moved=3, seed=13, center_z=1.2):
    """synthesize_board_observations (every camera sees the whole board),
    numpy's global generator seeded, then noise_px of Gaussian noise and
    `moved` corners moved 25 px.  Returns (q (Nframes, Ncameras, H, W,
    2), Rt_ref_boardref)."""
    np.random.seed(seed)
    q, Rt = mrcal_tpu_torch.synthesize_board_observations(
        models, object_width_n=W, object_height_n=H, object_spacing=spacing,
        calobject_warp=np.array([0.002, -0.001]),
        rt_ref_boardcenter=np.array([0., 0., 0., 0., 0., center_z]),
        rt_ref_boardcenter__noiseradius=np.array(
            [np.pi / 6, np.pi / 6, np.pi / 9, 0.2, 0.2, 0.4]),
        Nframes=Nframes, which="all-cameras-must-see-full-board",
        device="cpu")
    rng = np.random.default_rng(seed)
    q = q + rng.normal(0.0, noise_px, q.shape)
    for k in range(moved):
        q[2 * k + 1, k % q.shape[1], k + 1, 2 * k + 1] += 25.0
    return q, Rt


def write_corners_vnl(path, q):
    """q (Nframes, Ncameras, H, W, 2) as a corners.vnl of level-0 rows,
    one image frame<f>-cam<c>.png per frame and camera."""
    lines = ["# filename x y level"]
    for f in range(q.shape[0]):
        for c in range(q.shape[1]):
            lines += [f"frame{f:03d}-cam{c}.png {x:.6f} {y:.6f} 0"
                      for x, y in q[f, c].reshape(-1, 2)]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


def _last_place(number):
    """One unit in the last printed place of a number's text."""
    mantissa, _, exponent = number.lower().partition("e")
    decimals = len(mantissa.partition(".")[2])
    return 10.0 ** (int(exponent or 0) - decimals)


def assert_report_matches(got, want, *, rtol=0.0, subs=()):
    """Two reports with the same words and, number for number, the same
    values: as printed, but for one unit in the last printed place (two
    roundings of values a roundoff apart can fall on either side of a
    digit), or within rtol.  subs: (text, replacement) pairs applied to
    both first (the output directories)."""
    for a, b in subs:
        got, want = got.replace(a, b), want.replace(a, b)
    words = [" ".join(NUMBER.sub("#", t).split()) for t in (got, want)]
    assert words[0] == words[1], (got, want)
    x, y = NUMBER.findall(got), NUMBER.findall(want)
    assert len(x) == len(y)
    for a, b in zip(x, y):
        tol = max(1.0001 * _last_place(b), rtol * abs(float(b)))
        assert abs(float(a) - float(b)) <= tol, (a, b, got, want)


def _solve_state(oi):
    b, x, _ = mrcal_tpu_torch.optimizer_callback(no_jacobian=True,
                                                 device="cpu", **oi)
    return b, float(np.sqrt(np.mean(x * x)))


def assert_models_match(path, path_ref, *, grid_px=GRID_PX_TOL, rt=RT_TOL,
                        rms_rtol=RMS_RTOL, b_tol=B_TOL):
    """The port's model file against the JAX package's: lens model, imager
    size and camera indices equal; the projection of a 30 x 22 grid of
    the JAX model's unprojections at 1 m within grid_px; the extrinsics
    within rt; and where they embed optimization_inputs, the same
    observation weights (outliers), the objective's rms at the two
    solutions within rms_rtol and the packed states within b_tol."""
    m, m_ref = (mrcal_tpu_torch.cameramodel(p) for p in (path, path_ref))
    assert m.intrinsics()[0] == m_ref.intrinsics()[0]
    assert np.array_equal(m.imagersize(), m_ref.imagersize())
    assert m.icam_intrinsics() == m_ref.icam_intrinsics()
    W, H = m_ref.imagersize()
    q = mrcal_tpu_torch.sample_imager(30, 22, W, H, device="cpu")
    v = mrcal_tpu_torch.unproject(q, *m_ref.intrinsics(), normalize=True,
                                  device="cpu")
    d = (mrcal_tpu_torch.project(v, *m.intrinsics(), device="cpu")
         - mrcal_tpu_torch.project(v, *m_ref.intrinsics(), device="cpu"))
    assert float(d.abs().max()) <= grid_px, float(d.abs().max())
    np.testing.assert_allclose(m.extrinsics_rt_fromref(),
                               m_ref.extrinsics_rt_fromref(), rtol=0,
                               atol=rt)
    oi, oi_ref = m.optimization_inputs(), m_ref.optimization_inputs()
    assert (oi is None) == (oi_ref is None)
    if oi is None:
        return
    assert np.array_equal(oi["observations_board"][..., 2] > 0,
                          oi_ref["observations_board"][..., 2] > 0)
    (b, rms), (b_ref, rms_ref) = _solve_state(oi), _solve_state(oi_ref)
    assert abs(rms - rms_ref) <= rms_rtol * rms_ref, (rms, rms_ref)
    assert np.abs(b - b_ref).max() <= b_tol, np.abs(b - b_ref).max()


def assert_runs_match(got, want, outdirs=(), **report_tol):
    """The port's run_tool() result against the JAX script's: the exit
    code, and stdout and stderr by assert_report_matches."""
    subs = [(str(d), "OUT") for d in outdirs]
    assert got[0] == want[0], (got, want)
    assert_report_matches(got[1], want[1], subs=subs, **report_tol)
    assert_report_matches(got[2], want[2], subs=subs, **report_tol)


# ----------------------------------------------------------------------------
# the cases
# ----------------------------------------------------------------------------

def _args(vnl, outdir, *extra, cameras=2, model="LENSMODEL_OPENCV4"):
    return (["--corners-cache", str(vnl), "--lensmodel", model,
             "--object-spacing", "0.077", "--object-width-n", "8",
             "--object-height-n", "6", "--outdir", str(outdir)]
            + list(extra) + [f"*cam{c}*" for c in range(cameras)])


CASES = {
    "focal": dict(extra=("--focal", "750", "--imagersize", "800", "600")),
    "skip_outlier_rejection": dict(extra=(
        "--focal", "750", "--imagersize", "800", "600",
        "--skip-outlier-rejection")),
    "seed": dict(extra=("--seed", "{seeds}", "--out-prefix", "seeded")),
    "splined": dict(extra=("--focal", "340", "--imagersize", "640", "480",
                           "--out-prefix", "splined"),
                    cameras=1, model=SPLINED, vnl="splined.vnl"),
}
# the JAX runs, one process each
GROUPS = (("focal",), ("skip_outlier_rejection",), ("seed",), ("splined",))
# the --explore shell's plots drawn: (name in the shell, the function,
# target, arguments, keywords) as jax_references.viz_explore_references
# takes them
EXPLORE_CALLS = [
    ("show_geometry", "show_geometry", "models", (),
     dict(hardcopy="{directory}/geometry.png")),
    ("show_projection_uncertainty", "show_projection_uncertainty",
     "camera 1", (), dict(gridn_width=8,
                          hardcopy="{directory}/uncertainty.png")),
    ("show_distortion_off_pinhole", "show_distortion_off_pinhole",
     "camera 0", (), dict(gridn_width=10,
                          hardcopy="{directory}/distortion.png")),
    ("show_valid_intrinsics_region", "show_valid_intrinsics_region",
     "camera 1", (), dict(hardcopy="{directory}/region.png")),
    ("show_residuals_vectorfield", "show_residuals_vectorfield", "oi", (),
     dict(hardcopy="{directory}/vectorfield.png")),
    ("show_residuals_histogram", "show_residuals_histogram", "oi", (),
     dict(binwidth=0.1, hardcopy="{directory}/histogram.png")),
    ("show_residuals_regional", "show_residuals_regional", "oi", (),
     dict(gridn_width=6, hardcopy="{directory}/regional.png")),
    ("show_residuals_board_observation", "show_residuals_board_observation",
     "oi", (2,), dict(hardcopy="{directory}/observation.png")),
    ("show_residuals_board_observation_worst",
     "show_residuals_board_observation", "oi", (0,),
     dict(hardcopy="{directory}/worst.png")),
]


def explore_inputs():
    """optimization_inputs of the scene at its truth: two OPENCV4 cameras,
    6 frames of the 8 x 6 board with 0.3 px of noise (no solve)."""
    models = scene_models()
    q, Rt = board_observations(models, 6, moved=0)
    Nf, Nc = q.shape[:2]
    return dict(
        intrinsics=np.array([m.intrinsics()[1] for m in models]),
        extrinsics_rt_fromref=np.array(
            [m.extrinsics_rt_fromref() for m in models[1:]]),
        frames_rt_toref=np.array([
            mrcal_tpu_torch.rt_from_Rt(R, device="cpu").numpy()
            for R in Rt]),
        observations_board=np.concatenate(
            [q, np.ones(q.shape[:-1] + (1,))], axis=-1).reshape(
                Nf * Nc, *q.shape[2:4], 3),
        indices_frame_camintrinsics_camextrinsics=np.array(
            [[f, c, c - 1] for f in range(Nf) for c in range(Nc)],
            dtype=np.int32),
        lensmodel="LENSMODEL_OPENCV4",
        imagersizes=np.array([m.imagersize() for m in models]),
        calobject_warp=np.array([0.002, -0.001]),
        calibration_object_spacing=0.077)


@pytest.fixture(scope="module")
def calib(tmp_path_factory):
    """The scenes' files, the argument lists of each case in each
    package's directory, and futures of the JAX runs."""
    root = tmp_path_factory.mktemp("calibrate")
    with jax_reference_pool(len(GROUPS) + 1) as pool:
        oi = explore_inputs()
        (root / "explore" / "jax").mkdir(parents=True)
        explore = pool.submit(viz_explore_references, oi,
                              str(root / "explore" / "jax"), EXPLORE_CALLS)
        models = scene_models()
        q, _ = board_observations(models, 10)
        write_corners_vnl(root / "corners.vnl", q)
        seeds = []
        for i, m in enumerate(models):
            lm, intr = m.intrinsics()
            intr = np.array(intr)
            intr[:2] *= 1.002
            seed = mrcal_tpu_torch.cameramodel(m)
            seed.intrinsics((lm, intr), imagersize=m.imagersize())
            seeds.append(str(root / f"seed{i}.cameramodel"))
            seed.write(seeds[-1])
        # the splined scene: one 640 x 480 camera, 12 frames at 0.8 m
        np.random.seed(2)
        intr = np.concatenate([[340., 339., 319.5, 239.5],
                               np.random.randn(2 * 7 * 5) * 2e-3])
        splined = mrcal_tpu_torch.cameramodel(
            intrinsics=(SPLINED, intr), imagersize=(640, 480),
            rt_cam_ref=np.zeros(6))
        q, _ = board_observations([splined], 12, spacing=0.08, moved=0,
                                  noise_px=0.1, seed=2, center_z=0.8)
        write_corners_vnl(root / "splined.vnl", q)

        argv = {}
        for name, case in CASES.items():
            extra = [e.format(seeds=",".join(seeds))
                     for e in case["extra"]]
            for pkg in ("jax", "torch"):
                out = root / name / pkg
                out.mkdir(parents=True)
                argv[name, pkg] = _args(root / case.get("vnl", "corners.vnl"),
                                        out, *extra,
                                        cameras=case.get("cameras", 2),
                                        model=case.get("model",
                                                       "LENSMODEL_OPENCV4"))
        futures = {}
        for group in GROUPS:
            f = pool.submit(run_jax_tools,
                            [("calibrate-cameras", argv[n, "jax"], "")
                             for n in group])
            for i, n in enumerate(group):
                futures[n] = (f, i)
        futures["explore"] = (oi, explore)
        yield root, argv, futures


def _jax(calib, name):
    f, i = calib[2][name]
    return f.result(timeout=900)[i]


@pytest.mark.parametrize("name", list(CASES))
def test_calibrate_cameras_matches_jax(calib, name):
    root, argv, _ = calib
    got = run_tool("torch", "calibrate-cameras", argv[name, "torch"])
    want = _jax(calib, name)
    assert got[0] == 0 and want[0] == 0, (got[:3], want)
    assert_runs_match(got, want, (root / name / "jax", root / name / "torch"))
    result = got[3]
    files = sorted(os.listdir(root / name / "jax"))
    assert files == sorted(os.listdir(root / name / "torch"))
    assert len(files) == CASES[name].get("cameras", 2)
    for f in files:
        assert_models_match(root / name / "torch" / f, root / name / "jax" / f)
    # the report's numbers are the returned solve's
    stats = result["stats"]
    assert f"RMS reprojection error: " \
        f"{stats['rms_reproj_error__pixels']:.2f} pixels" in got[1]
    outliers = stats["Noutliers_board"]
    if name == "skip_outlier_rejection":
        assert "Noutliers" not in got[1] and outliers == 0
    elif name != "splined":
        assert outliers >= 3 and f"Noutliers: {outliers} out of" in got[1]
    else:
        # the staged solve resets fxycxy for a splined model (reference
        # mrcal-calibrate-cameras:461): one fxy, cxy at the imager's center
        assert "## initial solve: geometry with splined-nominal fxycxy " \
            "locked" in got[1]
        lm, intr = result["models"][0].intrinsics()
        assert lm == SPLINED and intr[0] == intr[1]
        assert np.array_equal(intr[2:4], [319.5, 239.5])


def _jax_explore_names():
    """The names of the JAX mrcal-calibrate-cameras --explore shell: the
    keywords of the dict its _explore builds."""
    import ast
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tools",
            "mrcal-calibrate-cameras")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "_explore")
    call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "dict")
    return sorted(k.arg for k in call.keywords)


def test_explore_namespace_draws_what_jax_draws(calib, saved_figures):
    """--explore's shell has the JAX script's names, and its show_* draw,
    on the device given, the figures the JAX package's show_* draw when
    called as the JAX shell calls them."""
    from mrcal_tpu_torch.tools import calibrate_cameras
    root, _, futures = calib
    oi, explore = futures["explore"]
    models = [mrcal_tpu_torch.cameramodel(optimization_inputs=oi,
                                          icam_intrinsics=i)
              for i in range(len(oi["intrinsics"]))]
    models[1].extrinsics_rt_fromref(oi["extrinsics_rt_fromref"][0])
    ns = calibrate_cameras.explore_namespace(models, oi, {}, None, "cpu")
    assert sorted(ns) == _jax_explore_names()
    directory = root / "explore" / "torch"
    directory.mkdir()
    for name, _, target, args, kw in EXPLORE_CALLS:
        kw = {k: v.format(directory=directory) if isinstance(v, str) else v
              for k, v in kw.items()}
        if target.startswith("camera"):
            kw["icam"] = int(target.split()[1])
        ns[name](*args, **kw)
    want = explore.result(timeout=900)
    assert len(saved_figures) == len(want) == len(EXPLORE_CALLS)
    for (name, *_), a, b in zip(EXPLORE_CALLS, saved_figures, want):
        assert_contents_match(a, b, name)
    assert sorted(os.listdir(directory)) == \
        sorted(os.listdir(root / "explore" / "jax"))
