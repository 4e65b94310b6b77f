"""The port's tools of models, corners and poses against the JAX package's
scripts, on the CPU: mrcal-reoptimize, mrcal-convert-lensmodel (the
re-solve, --monocular, --sampled with --num-trials, --viz),
mrcal-triangulate (a pixel pair with both noises, a range estimate and
--make-corrected-model1; a feature found in two images; --viz uncertainty
with both noises and with none),
mrcal-report-fov, mrcal-reproject-points, mrcal-is-within-valid-
intrinsics-region, mrcal-graft-models, mrcal-to-cahvor, mrcal-from-cahvor,
mrcal-cull-corners, mrcal-rotate-corners, mrcal-to-kalibr, mrcal-from-
kalibr and mrcal-from-ros.

The inputs: a two-camera OPENCV8 calibration (tests/test_calibration.py's
make_scene cameras, 10 frames of an 8 x 6 board, 0.3 px of noise) solved
by the port and written as camera-0/1.cameramodel, its corners.vnl, a
CAHVOR model, kalibr and ROS yaml files and two 800 x 600 textured
images.  Each tool's exit code and report are held to the JAX script's
(tests/test_torch_tools_calibrate.py's assert_report_matches: the same
words, the numbers as printed but for one unit in the last place), its
text outputs byte for byte where they are text of the inputs, and its
models by assert_models_match (rms 1e-10 relative and b 1e-5 where they
embed a solve; the grid projections 1e-5 px and the extrinsics 1e-7, or
what a case states).  The --viz figures are held to the JAX script's by
tests/test_torch_visualization.py's comparison (texts equal, arrays
within 1e-8 of their largest entry; the convert-lensmodel diff, between
each package's own re-solve, within GRID_PX_TOL).

The JAX scripts run in six processes started before the first test
(jax_reference_pool): reoptimize, the re-solve, the other conversions,
triangulate with calibration noise (and the --viz uncertainty cases),
--viz of convert-lensmodel, and the rest.
"""

import io
import os

import numpy as np
import pytest

import mrcal_tpu_torch

from jax_references import (dense_texture, jax_reference_pool,
                            run_jax_show_tools, run_jax_tools, run_tool)
from test_torch_residuals import torch_threads  # noqa: F401
from test_torch_tools_calibrate import (assert_models_match,
                                        assert_report_matches,
                                        assert_runs_match,
                                        board_observations, scene_models,
                                        write_corners_vnl)
from test_torch_tools_calibrate import GRID_PX_TOL
from test_torch_visualization import (  # noqa: F401
    assert_contents_match, saved_figures)

# the corrected camera-1 extrinsics come out of scipy's minimize of a
# function whose values differ by roundoff between the packages
CORRECTED_RT_TOL = 1e-6


def _solved_pair(root):
    """camera-0/1.cameramodel of the port's solve of the scene, and a copy
    of camera 0 with a valid-intrinsics region."""
    models = scene_models(model="LENSMODEL_OPENCV8")
    q, Rt = board_observations(models, 10, moved=0)
    write_corners_vnl(root / "corners.vnl", q)
    Nf, Nc = q.shape[:2]
    oi = dict(
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
        lensmodel="LENSMODEL_OPENCV8",
        imagersizes=np.array([m.imagersize() for m in models]),
        calobject_warp=np.array([0.002, -0.001]),
        calibration_object_spacing=0.077,
        do_apply_outlier_rejection=False)
    mrcal_tpu_torch.optimize(device="cpu", **oi)
    paths = []
    for i in range(Nc):
        paths.append(str(root / f"camera-{i}.cameramodel"))
        mrcal_tpu_torch.cameramodel(optimization_inputs=oi,
                                    icam_intrinsics=i).write(paths[-1])
    m = mrcal_tpu_torch.cameramodel(paths[0])
    m.valid_intrinsics_region(np.array(
        [[100.5, 80.25], [700, 90], [690, 520], [110, 510], [100.5, 80.25]]))
    paths.append(str(root / "region.cameramodel"))
    m.write(paths[-1])
    return paths


def _feature_images(root, m0, m1, q0, r):
    """Two 800 x 600 textures, the second the first shifted so that camera
    0's pixel q0 lands 2 px right of and 1 px above where a point r m away
    on its ray would be seen by camera 1."""
    v = mrcal_tpu_torch.unproject(q0, *m0.intrinsics(), normalize=True,
                                  device="cpu") * r
    Rt10 = mrcal_tpu_torch.compose_Rt(m1.Rt_cam_ref(), m0.Rt_ref_cam(),
                                      device="cpu")
    q1 = mrcal_tpu_torch.project(
        mrcal_tpu_torch.transform_point_Rt(Rt10, v, device="cpu"),
        *m1.intrinsics(), device="cpu").numpy()
    shift = np.round(q1 - q0).astype(int) + [2, -1]
    im0 = np.clip(dense_texture((600, 800), 21) / 4, 0, 255).astype(np.uint8)
    im1 = np.roll(im0, (shift[1], shift[0]), axis=(0, 1))
    paths = [str(root / f"feature{i}.png") for i in (0, 1)]
    for p, im in zip(paths, (im0, im1)):
        mrcal_tpu_torch.save_image(p, im)
    return paths


KALIBR = """cam0:
  camera_model: pinhole
  intrinsics: [751.5, 749.25, 401.0, 297.5]
  distortion_model: radtan
  distortion_coeffs: [-0.02, 0.01, 0.001, -0.002]
  resolution: [800, 600]
cam1:
  camera_model: pinhole
  intrinsics: [760.0, 758.5, 398.0, 301.0]
  distortion_model: none
  distortion_coeffs: []
  resolution: [800, 600]
  T_cn_cnm1:
  - [0.9998, -0.0100, 0.0158, -0.21]
  - [0.0101, 0.9999, -0.0050, 0.003]
  - [-0.0157, 0.0052, 0.9998, 0.01]
  - [0.0, 0.0, 0.0, 1.0]
"""

ROS = """image_width: 800
image_height: 600
camera_matrix: {rows: 3, cols: 3, data: [750.5, 0, 399.5, 0, 748.0, 300.25,
                                         0, 0, 1]}
distortion_coefficients: {rows: 1, cols: 5,
                          data: [-0.1, 0.02, 0.001, -0.002, 0.003]}
"""


def _inputs(root):
    """Every input file: name -> path."""
    paths = dict(zip(("cam0", "cam1", "region"), _solved_pair(root)))
    paths["vnl"] = str(root / "corners.vnl")
    m0, m1 = (mrcal_tpu_torch.cameramodel(paths[k]) for k in ("cam0", "cam1"))
    paths["im0"], paths["im1"] = _feature_images(
        root, m0, m1, np.array([420.0, 310.0]), 3.0)
    cahvor = mrcal_tpu_torch.cameramodel(
        intrinsics=("LENSMODEL_CAHVOR", [750.0, 748.5, 401.5, 297.0, 0.01,
                                         -0.02, 0.0, -0.05, 0.01]),
        imagersize=(800, 600),
        rt_cam_ref=np.array([0.01, -0.02, 0.03, 0.1, -0.2, 0.3]))
    paths["cahvor_model"] = str(root / "cahvor.cameramodel")
    cahvor.write(paths["cahvor_model"])
    paths["cahvor"] = str(root / "camera.cahvor")
    cahvor.write(paths["cahvor"])
    for name, text in (("kalibr", KALIBR), ("ros", ROS)):
        paths[name] = str(root / f"{name}.yaml")
        with open(paths[name], "w") as f:
            f.write(text)
    for pkg in ("jax", "torch"):
        os.mkdir(root / pkg)
    return paths


POINTS = "# x y\n0 0\n100.5 80.25\n420 310\n799 599\n650.25 120.5\n"

# name -> (tool, argv with {input} and {out} placeholders, stdin); {out}
# is each package's own output directory
CASES = {
    "reoptimize": ("reoptimize", ["{cam0}"], ""),
    "convert_resolve": ("convert-lensmodel",
                        ["LENSMODEL_OPENCV4", "{cam1}"], ""),
    "convert_monocular": ("convert-lensmodel",
                          ["--monocular", "--outfile",
                           "{out}/monocular.cameramodel",
                           "LENSMODEL_OPENCV4", "{cam0}"], ""),
    "convert_sampled": ("convert-lensmodel",
                        ["--sampled", "--num-trials", "2", "--gridn", "20",
                         "14", "LENSMODEL_OPENCV4", "{cam0}"], ""),
    "triangulate_pair": ("triangulate",
                         ["--q-calibration-stdev", "0.3",
                          "--q-observation-stdev", "0.3",
                          "--range-estimate", "3.1",
                          "--make-corrected-model1", "{cam0}", "{cam1}",
                          "420", "310", "{q1x}", "{q1y}"], ""),
    "triangulate_images": ("triangulate",
                           ["--q-observation-stdev", "0.3",
                            "--range-estimate", "3.0", "{cam0}", "{cam1}",
                            "420", "310", "{im0}", "{im1}"], ""),
    "report_fov": ("report-fov", ["{cam0}"], ""),
    "reproject_points": ("reproject-points", ["{cam0}", "{cam1}"], POINTS),
    "reproject_points_intrinsics": ("reproject-points",
                                    ["--intrinsics-only", "{cam0}",
                                     "{cam1}"], POINTS),
    "is_within_region": ("is-within-valid-intrinsics-region", ["{region}"],
                         POINTS),
    "is_within_no_region": ("is-within-valid-intrinsics-region", ["{cam0}"],
                            POINTS),
    "graft_models": ("graft-models", ["{cam0}", "{cam1}"], ""),
    "to_cahvor": ("to-cahvor", ["{cahvor_model}"], ""),
    "to_cahvor_pinhole": ("to-cahvor", ["{cam1}"], ""),
    "from_cahvor": ("from-cahvor", ["{cahvor}"], ""),
    "cull_corners": ("cull-corners",
                     ["--imagersize", "800", "600", "--cull-rad-off-center",
                      "250", "--exclude-images", "frame003-*", "{vnl}"], ""),
    "rotate_corners": ("rotate-corners",
                       ["--rot", "90", "--object-width-n", "8",
                        "--object-height-n", "6", "{vnl}"], ""),
    "to_kalibr": ("to-kalibr", ["{cam0}", "{cam1}"], ""),
    "from_kalibr": ("from-kalibr", ["--outdir", "{out}", "{kalibr}"], ""),
    "from_ros": ("from-ros", ["{ros}"], ""),
    "convert_viz": ("convert-lensmodel",
                    ["--viz", "--title", "old vs new", "--hardcopy",
                     "{out}/convert-viz.png", "--outfile",
                     "{out}/viz.cameramodel", "LENSMODEL_OPENCV4", "{cam0}"],
                    ""),
    "triangulate_viz": ("triangulate",
                        ["--q-calibration-stdev", "0.3",
                         "--q-observation-stdev", "0.3", "--viz",
                         "uncertainty", "--extratitle", "both noises",
                         "--hardcopy", "{out}/ellipses.png", "{cam0}",
                         "{cam1}", "420", "310", "{q1x}", "{q1y}"], ""),
    "triangulate_viz_none": ("triangulate",
                             ["--viz", "uncertainty", "--hardcopy",
                              "{out}/none.png", "{cam0}", "{cam1}", "420",
                              "310", "{q1x}", "{q1y}"], ""),
}
GROUPS = (("reoptimize",), ("convert_resolve",),
          ("convert_monocular", "convert_sampled"),
          ("triangulate_pair", "triangulate_viz", "triangulate_viz_none"),
          ("convert_viz",),
          ("triangulate_images",) + tuple(
              n for n in CASES
              if not n.startswith(("reoptimize", "convert", "triangulate"))))
# the --viz cases: the files each writes, and the tolerance of its figure's
# arrays
DRAWING = {"convert_viz": (["convert-viz.png", "viz.cameramodel"],
                           GRID_PX_TOL),
           "triangulate_viz": (["ellipses.png"], 0.0),
           "triangulate_viz_none": ([], 0.0)}
# the cases whose stdout is a model file
MODEL_STDOUT = ("reoptimize", "convert_resolve", "convert_sampled",
                "graft_models", "from_cahvor", "from_ros")


@pytest.fixture(scope="module")
def tools(tmp_path_factory):
    """The inputs, each case's argument lists in both packages, and
    futures of the JAX runs."""
    root = tmp_path_factory.mktemp("tools")
    with jax_reference_pool(len(GROUPS)) as pool:
        paths = _inputs(root)
        m0, m1 = (mrcal_tpu_torch.cameramodel(paths[k])
                  for k in ("cam0", "cam1"))
        # camera 1's view of the point 3 m along camera 0's pixel, 0.3 px
        # off
        v = mrcal_tpu_torch.unproject([420.0, 310.0], *m0.intrinsics(),
                                      normalize=True, device="cpu") * 3.0
        Rt10 = mrcal_tpu_torch.compose_Rt(m1.Rt_cam_ref(), m0.Rt_ref_cam(),
                                          device="cpu")
        q1 = mrcal_tpu_torch.project(
            mrcal_tpu_torch.transform_point_Rt(Rt10, v, device="cpu"),
            *m1.intrinsics(), device="cpu").numpy() + [0.3, -0.2]
        argv = {}
        for name, (_, args, _) in CASES.items():
            for pkg in ("jax", "torch"):
                argv[name, pkg] = [a.format(out=root / pkg, q1x=q1[0],
                                            q1y=q1[1], **paths)
                                   for a in args]
        for name in DRAWING:
            for pkg in ("jax", "torch"):
                out = root / name / pkg
                out.mkdir(parents=True)
                argv[name, pkg] = [a.format(out=out, q1x=q1[0], q1y=q1[1],
                                            **paths) for a in CASES[name][1]]
        futures = {}
        for group in GROUPS:
            run = (run_jax_show_tools if set(group) & set(DRAWING)
                   else run_jax_tools)
            f = pool.submit(run, [
                (CASES[n][0], argv[n, "jax"], CASES[n][2]) for n in group])
            for i, n in enumerate(group):
                futures[n] = (f, i)
        yield root, argv, futures


def _run(tools, name):
    """(the port's run, the JAX script's run: exit code, stdout, stderr)
    of a case."""
    _, argv, futures = tools
    tool, _, stdin = CASES[name]
    got = run_tool("torch", tool, argv[name, "torch"], stdin)
    f, i = futures[name]
    return got, f.result(timeout=900)[i][:3]


def _stdout_model(root, pkg, name, text):
    path = root / pkg / f"{name}.stdout.cameramodel"
    path.write_text(text)
    return path


@pytest.mark.parametrize("name", MODEL_STDOUT)
def test_model_on_stdout_matches_jax(tools, name):
    """The tools that write a model on standard output: the model by
    assert_models_match, and the report on stderr."""
    root = tools[0]
    got, want = _run(tools, name)
    assert got[0] == 0 and want[0] == 0, (got[:3], want)
    assert_report_matches(got[2], want[2])
    assert_models_match(_stdout_model(root, "torch", name, got[1]),
                        _stdout_model(root, "jax", name, want[1]))
    if name == "convert_sampled":
        # --num-trials 2: the fit from seed 1 too, and the lower rms kept
        assert "(280 grid points x 1 distance(s))" in got[2]
        assert f"sampled fit rms: {got[3]['rms']:.4f} px" in got[2]


def test_convert_monocular_matches_jax(tools):
    root = tools[0]
    got, want = _run(tools, "convert_monocular")
    assert_runs_match(got, want, (root / "jax", root / "torch"))
    assert_models_match(root / "torch" / "monocular.cameramodel",
                        root / "jax" / "monocular.cameramodel")
    assert got[3]["optimization_inputs"]["intrinsics"].shape == (1, 8)


@pytest.mark.parametrize("name", ["triangulate_pair", "triangulate_images"])
def test_triangulate_matches_jax(tools, name):
    """The report (and the corrected camera-1 model on stdout: its
    extrinsics within CORRECTED_RT_TOL, the rest as read) against the JAX
    script's."""
    got, want = _run(tools, name)
    assert got[0] == 0 and want[0] == 0, (got[:3], want)
    split = [t[1].partition("\n{") for t in (got, want)]
    assert_report_matches(split[0][0], split[1][0])
    assert got[2] == want[2]
    if name == "triangulate_pair":
        models = [mrcal_tpu_torch.cameramodel(io.StringIO("{" + s[2]))
                  for s in split]
        np.testing.assert_allclose(models[0].extrinsics_rt_fromref(),
                                   models[1].extrinsics_rt_fromref(),
                                   rtol=0, atol=CORRECTED_RT_TOL)
        assert np.array_equal(models[0].intrinsics()[1],
                              models[1].intrinsics()[1])
        for key in ("calibration-time sigma", "observation-time sigma",
                    "dyaw", "rt10_corrected"):
            assert key in got[3]
    else:
        assert "## Feature match found at" in got[1]


@pytest.mark.parametrize("name", [
    "report_fov", "reproject_points", "reproject_points_intrinsics",
    "is_within_region", "is_within_no_region", "to_kalibr"])
def test_report_matches_jax(tools, name):
    got, want = _run(tools, name)
    assert got[0] == 0
    assert_runs_match(got, want)


@pytest.mark.parametrize("name", ["to_cahvor", "to_cahvor_pinhole",
                                  "cull_corners", "rotate_corners"])
def test_text_output_is_the_jax_scripts(tools, name):
    """Text made of the inputs' text or written by the same format code:
    byte for byte."""
    got, want = _run(tools, name)
    assert got[:3] == want
    assert got[1]


def test_from_kalibr_matches_jax(tools):
    root = tools[0]
    got, want = _run(tools, "from_kalibr")
    assert_runs_match(got, want, (root / "jax", root / "torch"))
    for name in ("cam0", "cam1"):
        f = f"{name}.cameramodel"
        assert_models_match(root / "torch" / f, root / "jax" / f,
                            grid_px=0, rt=1e-15)


@pytest.mark.parametrize("name", list(DRAWING))
def test_drawing_options_draw_what_jax_draws(tools, saved_figures, name):
    """convert-lensmodel --viz (the projection difference between the
    model and its conversion) and triangulate --viz uncertainty (the
    ellipses; a warning and no file without noise): the same reports,
    files and figures as the JAX scripts'."""
    root, _, futures = tools
    got, want = _run(tools, name)
    f, i = futures[name]
    want_figures = f.result(timeout=900)[i][3]
    outdirs = [root / name / pkg for pkg in ("jax", "torch")]
    assert got[0] == 0 and want[0] == 0, (got[:3], want)
    assert_runs_match(got, want, outdirs)
    if name == "convert_viz":
        assert_models_match(outdirs[1] / "viz.cameramodel",
                            outdirs[0] / "viz.cameramodel")
    assert ("## WARNING: don't have any ellipses" in got[1]) == \
        (name == "triangulate_viz_none")
    files, atol = DRAWING[name]
    for d in outdirs:
        assert sorted(p.name for p in d.iterdir()) == files
    assert len(saved_figures) == len(want_figures) == (1 if files else 0)
    for a, b in zip(saved_figures, want_figures):
        assert_contents_match(a, b, name, atol)
