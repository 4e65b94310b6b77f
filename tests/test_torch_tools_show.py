"""The port's ten mrcal-show-* tools (mrcal_tpu_torch.tools.show_*) against
the JAX package's scripts, on the CPU.

The inputs: tests/test_torch_tools_models.py's two-camera OPENCV8
calibration (10 frames of an 8 x 6 board, 0.3 px of noise, solved by the
port) as camera-0/1.cameramodel and camera 0 with a valid-intrinsics
region; camera 1 yawed by 1 mrad (a second calibration of the pair); a 9
x 7-knot splined model and an 800 x 600 image.  Each case runs the port's
main(argv, device="cpu") and the JAX script on the same files, each into
a directory of its own, and holds the port's run to the script's: the
exit code, the report lines (assert_report_matches: the same words, the
numbers as printed but for one unit in the last place), the names of the
files written, and figure_contents of every figure saved (matplotlib's
Figure.savefig recorded in both processes) by tests/
test_torch_visualization.py's comparison: texts equal, arrays within
1e-8 of their largest entry.

The JAX scripts run in four processes started before the first test
(jax_reference_pool), one per group of cases.
"""

import os

import numpy as np
import pytest

import mrcal_tpu_torch

from jax_references import (VIZ_SPLINED, close_figures, jax_reference_pool,
                            run_jax_show_tools, run_tool)
from test_torch_residuals import torch_threads  # noqa: F401
from test_torch_tools_calibrate import assert_runs_match
from test_torch_tools_models import _solved_pair
from test_torch_visualization import (  # noqa: F401
    assert_contents_match, board_image, saved_figures)

# name -> (tool, argv with {input} and {out} placeholders, the files it
# writes into {out})
CASES = {
    "distortion": ("show-distortion-off-pinhole",
                   ["--hardcopy", "{out}/distortion.png", "{cam0}"],
                   ["distortion.png"]),
    "distortion_vectorfield": ("show-distortion-off-pinhole",
                               ["--vectorfield", "--hardcopy",
                                "{out}/vectorfield.png", "{cam1}"],
                               ["vectorfield.png"]),
    "distortion_radial": ("show-distortion-off-pinhole",
                          ["--radial", "--hardcopy", "{out}/radial.png",
                           "{cam0}"], ["radial.png"]),
    "geometry": ("show-geometry",
                 ["--hardcopy", "{out}/geometry.png", "{cam0}", "{cam1}"],
                 ["geometry.png"]),
    "geometry_calobjects": ("show-geometry",
                            ["--show-calobjects", "--axis-scale", "0.05",
                             "--hardcopy", "{out}/calobjects.png",
                             "{cam1}", "{cam0}"], ["calobjects.png"]),
    "model_resolution": ("show-model-resolution",
                         ["--gridn", "8", "6", "--hardcopy",
                          "{out}/resolution.png", "{cam0}"],
                         ["resolution.png"]),
    "model_resolution_report": ("show-model-resolution",
                                ["--gridn", "8", "6", "{cam1}"], []),
    "projection_diff": ("show-projection-diff",
                        ["--gridn", "12", "9", "--hardcopy",
                         "{out}/diff.png", "{cam0}", "{cam1}"],
                        ["diff.png"]),
    "projection_diff_vectorfield": ("show-projection-diff",
                                    ["--vectorfield", "--intrinsics-only",
                                     "--distance", "2", "--cbmax", "10",
                                     "--gridn", "12", "9", "--hardcopy",
                                     "{out}/vf.png", "{cam0}", "{cam1}"],
                                    ["vf.png"]),
    "projection_diff_report": ("show-projection-diff",
                               ["--gridn", "12", "9", "{cam0}", "{cam1y}"],
                               []),
    "uncertainty": ("show-projection-uncertainty",
                    ["--gridn", "12", "9", "--hardcopy",
                     "{out}/uncertainty.png", "{cam0}"],
                    ["uncertainty.png"]),
    "uncertainty_isotropic": ("show-projection-uncertainty",
                              ["--gridn", "12", "9", "--isotropic",
                               "--distance", "3", "--cbmax", "1",
                               "--hardcopy", "{out}/isotropic.png",
                               "{cam1}"], ["isotropic.png"]),
    "uncertainty_vs_distance_at": ("show-projection-uncertainty",
                                   ["--vs-distance-at", "400,300",
                                    "--hardcopy", "{out}/at.png", "{cam1}"],
                                   ["at.png"]),
    "residuals": ("show-residuals",
                  ["--hardcopy", "{out}/vectorfield.png", "{cam0}"],
                  ["vectorfield.png"]),
    "residuals_histogram": ("show-residuals",
                            ["--histogram", "--hardcopy",
                             "{out}/histogram.png", "{cam1}"],
                            ["histogram.png"]),
    "residuals_magnitudes": ("show-residuals",
                             ["--magnitudes", "--hardcopy",
                              "{out}/magnitudes.png", "{cam0}"],
                             ["magnitudes.png"]),
    "residuals_directions": ("show-residuals",
                             ["--directions", "--hardcopy",
                              "{out}/directions.png", "{cam1}"],
                             ["directions.png"]),
    "residuals_regional": ("show-residuals",
                           ["--regional", "--hardcopy", "{out}/regional.png",
                            "{region}"], ["regional.png"]),
    "residuals_no_solve": ("show-residuals", ["{splined}"], []),
    "board_observations": ("show-residuals-board-observation",
                           ["--hardcopy", "{out}/observation.png", "{cam0}",
                            "0", "3"],
                           ["observation-0.png", "observation-3.png"]),
    "board_observation": ("show-residuals-board-observation",
                          ["--hardcopy", "{out}/one.png", "{cam1}", "5"],
                          ["one.png"]),
    "splined": ("show-splined-model-correction",
                ["--hardcopy", "{out}/splined.png", "{splined}"],
                ["splined.png"]),
    "splined_vectorfield": ("show-splined-model-correction",
                            ["--vectorfield", "--hardcopy",
                             "{out}/splined-vf.png", "{splined}"],
                            ["splined-vf.png"]),
    "stereo_pair_diff": ("show-stereo-pair-diff",
                         ["--hardcopy", "{out}/pair.png", "{cam0}",
                          "{cam1}", "{cam0}", "{cam1y}"], ["pair.png"]),
    "stereo_pair_diff_report": ("show-stereo-pair-diff",
                                ["--az-fov-deg", "40", "--el-fov-deg", "30",
                                 "{cam0}", "{cam1}", "{cam0}", "{cam1}"],
                                []),
    "valid_region": ("show-valid-intrinsics-region",
                     ["--hardcopy", "{out}/region.png", "{region}"],
                     ["region.png"]),
    "valid_region_image": ("show-valid-intrinsics-region",
                           ["--image", "{image}", "--hardcopy",
                            "{out}/over-image.png", "{region}", "{cam1}"],
                           ["over-image.png"]),
}
# the JAX reference processes' shares of the cases: the first whose
# prefixes a case's name starts with
GROUP_PREFIXES = (("uncertainty",), ("model",),
                  ("projection", "stereo", "distortion"),
                  ("residuals", "board", "geometry", "splined", "valid"))
GROUPS = tuple(
    tuple(n for n in CASES
          if next(i for i, p in enumerate(GROUP_PREFIXES)
                  if n.startswith(p)) == k)
    for k in range(len(GROUP_PREFIXES)))


def _inputs(root):
    paths = dict(zip(("cam0", "cam1", "region"), _solved_pair(root)))
    m1 = mrcal_tpu_torch.cameramodel(paths["cam1"])
    rt = m1.extrinsics_rt_fromref()
    rt_yaw = mrcal_tpu_torch.compose_rt(
        np.array([0.0, 1e-3, 0.0, 0.0, 0.0, 0.0]), rt, device="cpu").numpy()
    m1.extrinsics_rt_fromref(rt_yaw)
    paths["cam1y"] = str(root / "camera-1-yawed.cameramodel")
    m1.write(paths["cam1y"])
    rng = np.random.default_rng(4)
    splined = mrcal_tpu_torch.cameramodel(
        intrinsics=(VIZ_SPLINED, np.concatenate(
            [[420., 419., 399.5, 299.5], rng.normal(size=2 * 9 * 7) * 2e-3])),
        imagersize=(800, 600))
    paths["splined"] = str(root / "splined.cameramodel")
    splined.write(paths["splined"])
    paths["image"] = str(root / "board.png")
    board_image(paths["image"])
    return paths


@pytest.fixture(scope="module")
def show(tmp_path_factory):
    """The inputs, each case's argument lists and output directories in
    both packages, and futures of the JAX runs."""
    root = tmp_path_factory.mktemp("show")
    with jax_reference_pool(len(GROUPS)) as pool:
        paths = _inputs(root)
        argv, outdirs = {}, {}
        for name, (_, args, _) in CASES.items():
            for pkg in ("jax", "torch"):
                out = root / name / pkg
                out.mkdir(parents=True)
                outdirs[name, pkg] = out
                argv[name, pkg] = [a.format(out=out, **paths) for a in args]
        futures = {}
        for group in GROUPS:
            f = pool.submit(run_jax_show_tools, [
                (CASES[n][0], argv[n, "jax"], "") for n in group])
            for i, n in enumerate(group):
                futures[n] = (f, i)
        yield paths, argv, outdirs, futures


def test_every_show_script_has_cases():
    scripts = sorted(f[len("mrcal-"):] for f in os.listdir(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tools")) if f.startswith("mrcal-show-"))
    assert len(scripts) == 10
    assert sorted({tool for tool, _, _ in CASES.values()}) == scripts


@pytest.mark.parametrize("name", list(CASES))
def test_show_tool_matches_jax(show, saved_figures, name):
    _, argv, outdirs, futures = show
    tool, _, files = CASES[name]
    got = run_tool("torch", tool, argv[name, "torch"])
    f, i = futures[name]
    want = f.result(timeout=900)[i]
    assert_runs_match(got, want, (outdirs[name, "jax"],
                                  outdirs[name, "torch"]))
    for pkg in ("jax", "torch"):
        assert sorted(os.listdir(outdirs[name, pkg])) == sorted(files), pkg
    assert len(saved_figures) == len(want[3])
    for k, (a, b) in enumerate(zip(saved_figures, want[3])):
        assert_contents_match(a, b, f"{name} figure {k}")
    if name == "residuals_no_solve":
        assert got[0] == 1 and "no optimization_inputs" in got[2]
    elif name.endswith("_report"):
        assert got[0] == 0 and got[1] and not saved_figures


def test_show_geometry_writes_a_png_to_stdout(show, capsysbinary):
    """Without --hardcopy, mrcal-show-geometry writes its plot to standard
    output as a PNG."""
    from mrcal_tpu_torch.tools import show_geometry
    paths = show[0]
    try:
        show_geometry.main([paths["cam0"], paths["cam1"]], device="cpu")
    finally:
        close_figures()
    out = capsysbinary.readouterr().out
    assert out.startswith(b"\x89PNG\r\n\x1a\n") and len(out) > 1000
