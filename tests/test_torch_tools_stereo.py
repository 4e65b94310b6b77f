"""The port's mrcal-stereo and mrcal-reproject-image against the JAX
package's scripts, on the CPU.

The inputs: the dense-stereo tests' two OPENCV8 cameras of 160 x 120, 0.2
m apart (jax_references.DENSE_MODELS cam0, and cam1 or cam1_region with a
valid-intrinsics region), and an 8-bit texture seen by camera 0 and,
shifted 6 px, by camera 1.  The cases:

  - mrcal-stereo by census + SGM (disparities 0-31), with the range image
    and the point cloud;
  - mrcal-stereo by NCC, with a region of interest and the
    valid-intrinsics mask of camera 1's region;
  - --viz geometry and --viz rectification, their figures held to the
    JAX script's by tests/test_torch_visualization.py's comparison (texts
    equal, arrays within 1e-8 of their largest entry);
  - mrcal-reproject-image to camera 0's corner-fit pinhole, and from
    camera 0 to camera 1 (--intrinsics-only).

Each run's exit code and report are held to the JAX script's (the numbers
as printed but for one unit in the last place); the images it writes
pixel for pixel; the point cloud's header byte for byte and its points to
one unit in the last written place (1e-4 m).

The JAX scripts run in four processes started before the first test
(jax_reference_pool): the SGM case, the NCC case, the reprojections and
the plots.
"""

import numpy as np
import pytest

import mrcal_tpu_torch

from jax_references import (DENSE_MODELS, dense_texture, jax_reference_pool,
                            run_jax_show_tools, run_jax_tools, run_tool)
from test_torch_residuals import torch_threads  # noqa: F401
from test_torch_tools_calibrate import assert_runs_match
from test_torch_visualization import (  # noqa: F401
    assert_contents_match, saved_figures)

PLY_TOL = 1.0001e-4


def _inputs(root):
    paths = {}
    for key in ("cam0", "cam1", "cam1_region"):
        paths[key] = str(root / f"{key}.cameramodel")
        mrcal_tpu_torch.cameramodel(**DENSE_MODELS[key]).write(paths[key])
    tex = np.clip(dense_texture((120, 200), 31) / 4, 0, 255).astype(np.uint8)
    for i, x0 in enumerate((20, 26)):
        paths[f"im{i}"] = str(root / f"image{i}.png")
        mrcal_tpu_torch.save_image(paths[f"im{i}"], tex[:, x0:x0 + 160])
    for pkg in ("jax", "torch"):
        (root / pkg).mkdir()
    return paths


RECT = ["--az-fov-deg", "60", "--el-fov-deg", "45"]
CASES = {
    "sgm": ("stereo", RECT + ["--disparity-range", "0", "31",
                              "--range-image", "--write-point-cloud",
                              "--outdir", "{out}", "{cam0}", "{cam1}",
                              "{im0}", "{im1}"],
            ["stereo-rectified0.png", "stereo-rectified1.png",
             "stereo-disparity.png", "stereo-range.png", "stereo.ply"]),
    "ncc": ("stereo", RECT + ["--matcher", "ncc", "--disparity-range", "0",
                              "23", "--roi", "20", "10", "120", "90",
                              "--valid-intrinsics-region", "--tag", "ncc",
                              "--outdir", "{out}", "{cam0}", "{cam1_region}",
                              "{im0}", "{im1}"],
            ["ncc-rectified0.png", "ncc-rectified1.png",
             "ncc-disparity.png"]),
    "reproject_pinhole": ("reproject-image",
                          ["--to-pinhole", "--fit", "corners", "--outfile",
                           "{out}/pinhole.png", "{cam0}", "{im0}"],
                          ["pinhole.png"]),
    "reproject_models": ("reproject-image",
                         ["--intrinsics-only", "--outfile",
                          "{out}/to-cam1.png", "{cam0}", "{cam1}", "{im0}"],
                         ["to-cam1.png"]),
}
GROUPS = (("sgm",), ("ncc",), ("reproject_pinhole", "reproject_models"))
# --viz: name -> (argv, the file it writes into {out})
VIZ_CASES = {
    "geometry": (RECT + ["--viz", "geometry", "--outdir", "{out}", "{cam0}",
                         "{cam1}", "{im0}", "{im1}"],
                 "stereo-geometry.png"),
    "rectification": (RECT + ["--viz", "rectification", "--title", "grids",
                              "--hardcopy", "{out}/rectification.png",
                              "{cam0}", "{cam1_region}", "{im0}", "{im1}"],
                      "rectification.png"),
}


@pytest.fixture(scope="module")
def stereo(tmp_path_factory):
    root = tmp_path_factory.mktemp("stereo")
    with jax_reference_pool(len(GROUPS) + 1) as pool:
        paths = _inputs(root)
        argv = {(name, pkg): [a.format(out=root / pkg, **paths)
                              for a in case[1]]
                for name, case in CASES.items() for pkg in ("jax", "torch")}
        for name, (args, _) in VIZ_CASES.items():
            for pkg in ("jax", "torch"):
                (root / name / pkg).mkdir(parents=True)
                argv[f"viz_{name}", pkg] = [
                    a.format(out=root / name / pkg, **paths) for a in args]
        futures = {}
        f = pool.submit(run_jax_show_tools, [
            ("stereo", argv[f"viz_{n}", "jax"], "") for n in VIZ_CASES])
        for i, n in enumerate(VIZ_CASES):
            futures[f"viz_{n}"] = (f, i)
        for group in GROUPS:
            f = pool.submit(run_jax_tools, [(CASES[n][0], argv[n, "jax"], "")
                                            for n in group])
            for i, n in enumerate(group):
                futures[n] = (f, i)
        yield root, argv, futures


def _assert_images_match(path, path_ref):
    a, b = (mrcal_tpu_torch.load_image(str(p)) for p in (path, path_ref))
    assert a.dtype == b.dtype and np.array_equal(a, b)


def _assert_ply_match(path, path_ref):
    text = [open(p).read().split("end_header\n") for p in (path, path_ref)]
    assert text[0][0] == text[1][0]
    points = [np.loadtxt(t[1].splitlines()).reshape(-1, 3) for t in text]
    assert points[0].shape == points[1].shape and len(points[0])
    assert np.abs(points[0] - points[1]).max() <= PLY_TOL


@pytest.mark.parametrize("name", list(CASES))
def test_tool_matches_jax(stereo, name):
    root, argv, futures = stereo
    tool, _, files = CASES[name]
    got = run_tool("torch", tool, argv[name, "torch"])
    f, i = futures[name]
    want = f.result(timeout=900)[i]
    assert got[0] == 0, got[:3]
    assert_runs_match(got, want, (root / "jax", root / "torch"))
    for fname in files:
        if fname.endswith(".ply"):
            _assert_ply_match(root / "torch" / fname, root / "jax" / fname)
        else:
            _assert_images_match(root / "torch" / fname, root / "jax" / fname)
    if tool == "stereo":
        out = got[3]
        valid = out["disparity"] > 0
        if name == "sgm":
            assert 0.3 < valid.mean() < 1.0
            assert np.array_equal(out["ranges"] > 0, valid)
            assert len(out["points"]) == valid.sum()
        else:
            # matched in the region of interest only
            roi = np.zeros_like(valid)
            roi[10:100, 20:140] = True
            assert 0.5 < valid[roi].mean() < 1.0 and not valid[~roi].any()


@pytest.mark.parametrize("name", list(VIZ_CASES))
def test_stereo_viz_draws_what_jax_draws(stereo, saved_figures, name):
    """--viz writes the JAX script's plot instead of running the
    pipeline: the same report and file, and the same figure."""
    root, argv, futures = stereo
    got = run_tool("torch", "stereo", argv[f"viz_{name}", "torch"])
    f, i = futures[f"viz_{name}"]
    want = f.result(timeout=900)[i]
    assert got[0] == 0 and want[0] == 0, (got[:3], want[:3])
    outdirs = [root / name / pkg for pkg in ("jax", "torch")]
    assert_runs_match(got, want, outdirs)
    for d in outdirs:
        assert sorted(p.name for p in d.iterdir()) == [VIZ_CASES[name][1]]
    assert len(saved_figures) == len(want[3]) == 1
    assert_contents_match(saved_figures[0], want[3][0], name)
    assert got[3]["hardcopy"].endswith(VIZ_CASES[name][1])
