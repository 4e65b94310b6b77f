"""The port's plots (mrcal_tpu_torch.visualization) against the JAX
package's, on the CPU.

The scene is tests/test_visualization.py's: make_scene(Ncameras=2,
Nframes=8), 0.2 px of noise, solved once by the JAX package in a
reference process; both packages build their models from the same solved
optimization_inputs (jax_references.viz_objects), so that no comparison
depends on a solve's trajectory.  Each case of jax_references.VIZ_CASES
(every show_* function, with its options) draws in both packages, and the
port's figure is held to the JAX package's by figure_contents: the
titles, labels, legends and texts equal (a decimal number printed in one
within one unit of its last place of the other's), every array (images,
extents, color limits, lines, collections, quivers, contour levels, axis
limits) within 1e-8 of its largest entry, and the array a show_* returns
beside its figure likewise.  Exceptions: the projection difference at 1
m within 1e-4 px (the implied transform's fit at a finite distance,
ROADMAP queue 3), and a histogram's bars compared where their edges
agree (a roundoff in the residuals' maximum may add a bin; the residuals
themselves are held to 1e-8 of the largest).  The three host helpers
give equal results, annotate_image__valid_intrinsics_region bit for bit.

The JAX references run in three reference processes (jax_reference_pool):
the solve, then three groups of cases at once.  (More processes finish
sooner alone, but each compiles the same programs again: under the
tier-1 run's six workers the CPU time is what counts.)
"""

import re

import numpy as np
import pytest

import mrcal_tpu_torch

from jax_references import (VIZ_CASES, VIZ_REGION, close_figures,
                            figure_contents, jax_reference_pool, viz_call,
                            viz_objects, viz_references, viz_solved_scene)
from test_torch_residuals import torch_threads  # noqa: F401

RTOL = 1e-8
# name -> the absolute tolerance of its arrays, where it is looser
ATOL = {"diff_1m": 1e-4}
# the JAX reference processes' shares of the cases: the first whose
# prefixes a case's name starts with (the last takes the rest)
GROUP_PREFIXES = (("uncertainty",),
                  ("diff", "stereo", "distortion", "radial", "splined"),
                  ("",))
GROUPS = tuple(
    tuple(n for n in VIZ_CASES
          if next(i for i, p in enumerate(GROUP_PREFIXES)
                  if n.startswith(p)) == k)
    for k in range(len(GROUP_PREFIXES)))


def board_image(path):
    """An 8-bit 800 x 600 checkerboard written to path."""
    ys, xs = np.mgrid[0:600, 0:800]
    mrcal_tpu_torch.save_image(path, np.where(
        (xs // 40 + ys // 40) % 2, 60, 200).astype(np.uint8))


@pytest.fixture(scope="module")
def viz(tmp_path_factory):
    """The port's objects of the cases, and the JAX package's figures of
    each (a function of the case's name)."""
    directory = tmp_path_factory.mktemp("viz")
    board_image(str(directory / "board.png"))
    with jax_reference_pool(len(GROUPS)) as pool:
        oi, x = pool.submit(viz_solved_scene).result(timeout=600)
        futures = {}
        for group in GROUPS:
            f = pool.submit(viz_references, oi, x, str(directory), group)
            futures.update(dict.fromkeys(group, f))
        objects = viz_objects(mrcal_tpu_torch, oi, x, str(directory))
        yield objects, lambda name: futures[name].result(timeout=600)


@pytest.fixture
def saved_figures(monkeypatch):
    """figure_contents of each figure the port saves while the test runs."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.figure
    saved = []
    savefig = matplotlib.figure.Figure.savefig

    def recording_savefig(self, *args, **kw):
        saved.append(figure_contents(self))
        return savefig(self, *args, **kw)
    monkeypatch.setattr(matplotlib.figure.Figure, "savefig",
                        recording_savefig)
    yield saved
    close_figures()


# ----------------------------------------------------------------------------
# the comparison of figure_contents
# ----------------------------------------------------------------------------

DECIMAL = re.compile(r"[-+]?\d+\.\d+(?:[eE][-+]?\d+)?")


def assert_text_matches(got, want, where):
    """Equal, or the same but for decimal numbers one unit in their last
    printed place apart."""
    if got == want:
        return
    assert DECIMAL.split(got) == DECIMAL.split(want), (where, got, want)
    for a, b in zip(DECIMAL.findall(got), DECIMAL.findall(want)):
        mantissa, _, exponent = b.lower().partition("e")
        last = 10.0 ** (int(exponent or 0) - len(mantissa.partition(".")[2]))
        assert abs(float(a) - float(b)) <= 1.0001 * last, (where, got, want)


def assert_array_matches(got, want, where, atol=0.0):
    """Same shape and NaNs; within RTOL of the largest finite entry (or
    atol)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (where, got.shape, want.shape)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), where
    if nan.all():
        return
    scale = np.abs(want[~nan]).max()
    err = np.abs(got[~nan] - want[~nan]).max()
    assert err <= max(RTOL * scale, atol), (where, err, scale)


def assert_bars_match(got, want, where, atol):
    """A histogram's bars: the heights of the bars whose left edges
    agree (all but one at either end)."""
    x, y = got["x"], want["x"]
    assert abs(len(x) - len(y)) <= 1, where
    n = min(len(x), len(y))
    for shift in (0, 1, -1):
        a, b = (slice(max(shift, 0), n + max(shift, 0)),
                slice(max(-shift, 0), n + max(-shift, 0)))
        xa, xb = x[a], y[b]
        if len(xa) == len(xb) == n and n and np.allclose(
                xa, xb, rtol=0, atol=RTOL * np.abs(y).max()):
            break
    else:
        raise AssertionError((where, x, y))
    assert n >= len(y) - 1, where
    for key in ("x", "width", "height"):
        assert_array_matches(got[key][a], want[key][b], f"{where}.{key}",
                             atol)


def assert_contents_match(got, want, where="figure", atol=0.0):
    """figure_contents of the port's figure against the JAX package's."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (where, sorted(got), sorted(want))
        if where.endswith(".patches") and len(want["x"]) > 1:
            assert_bars_match(got, want, where, atol)
            return
        for k in want:
            assert_contents_match(got[k], want[k], f"{where}.{k}", atol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (where, len(got), len(want))
        for i, (a, b) in enumerate(zip(got, want)):
            assert_contents_match(a, b, f"{where}[{i}]", atol)
    elif isinstance(want, str):
        assert_text_matches(got, want, where)
    else:
        assert_array_matches(got, want, where, atol)


# ----------------------------------------------------------------------------
# the cases
# ----------------------------------------------------------------------------

def test_every_show_function_has_cases():
    names = {n for n in dir(mrcal_tpu_torch) if n.startswith("show_")}
    assert len(names) == 15
    assert names == {case[0] for case in VIZ_CASES.values()}


@pytest.mark.parametrize("name", list(VIZ_CASES))
def test_show_matches_jax(viz, name):
    objects, references = viz
    contents, array = viz_call(mrcal_tpu_torch, VIZ_CASES[name], objects,
                               device="cpu")
    want = references(name)[name]
    atol = ATOL.get(name, 0.0)
    assert_contents_match(contents, want[0], name, atol)
    assert (array is None) == (want[1] is None)
    if array is not None:
        assert_array_matches(array, want[1], f"{name} returned", atol)


def test_board_residuals_match_jax(viz):
    """The residuals the histograms and the residual plots draw."""
    objects, references = viz
    from mrcal_tpu_torch.visualization import _board_residuals
    res, obs, idx = _board_residuals(objects["oi"], device="cpu")
    res_ref, obs_ref, idx_ref = references("histogram")["board_residuals"]
    assert_array_matches(res, res_ref, "residuals")
    assert np.array_equal(obs, obs_ref) and np.array_equal(idx, idx_ref)
    # the scene has outliers, which the plots mark
    assert (obs[..., 2] <= 0).any()


def _jax_model_with_region(jax_mrcal, oi):
    m = jax_mrcal.cameramodel(optimization_inputs=oi, icam_intrinsics=0)
    m.valid_intrinsics_region(VIZ_REGION)
    return m


@pytest.mark.parametrize("case", [
    "annotate_gray", "annotate_bgr", "annotate_color", "annotate_none",
    "gaussian_samples", "gaussian_statistics", "gaussian_both",
    "imagergrid", "imagergrid_height"])
def test_host_helpers_match_jax(viz, case):
    """The helpers that draw into an image or write gnuplot strings: equal
    results (the annotated images bit for bit; the errors alike)."""
    import mrcal_tpu
    objects = viz[0]
    outs = []
    for pkg, m0, m0r in ((mrcal_tpu_torch, objects["m0"], objects["m0r"]),
                         (mrcal_tpu, None, None)):
        if pkg is mrcal_tpu:
            m0 = mrcal_tpu.cameramodel(optimization_inputs=objects["oi"],
                                       icam_intrinsics=0)
            m0r = _jax_model_with_region(mrcal_tpu, objects["oi"])
        samples = np.random.default_rng(3).normal(0.1, 0.4, 500)
        try:
            if case.startswith("annotate"):
                image = (objects["gray"] if case == "annotate_gray"
                         else objects["bgr"]).copy()
                kw = dict(color=(10, 200, 30)) if case.endswith("color") \
                    else {}
                out = pkg.annotate_image__valid_intrinsics_region(
                    image, m0 if case == "annotate_none" else m0r, **kw)
                assert out is image
            elif case == "gaussian_samples":
                out = pkg.fitted_gaussian_equation(binwidth=0.05, x=samples)
            elif case == "gaussian_statistics":
                out = pkg.fitted_gaussian_equation(
                    binwidth=0.1, mean=1.0, sigma=2.0, N=50, legend="resid")
            elif case == "gaussian_both":
                out = pkg.fitted_gaussian_equation(binwidth=0.1, x=samples,
                                                   N=3)
            elif case == "imagergrid":
                out = pkg.imagergrid_using((100, 50), 11)
            else:
                out = pkg.imagergrid_using((800, 600), 30, 20)
        except Exception as e:
            out = ("raised", str(e))
        outs.append(out)
    got, want = outs
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want)
        blank = objects["gray" if case == "annotate_gray" else "bgr"]
        assert np.array_equal(want, blank) == (case == "annotate_none")
    else:
        assert got == want
    if case == "gaussian_both":
        assert want[0] == "raised"


def test_show_raises_without_matplotlib(viz, monkeypatch):
    """Where matplotlib cannot be imported, a show_* computes its data and
    then raises matplotlib's ImportError (no other drawing, nothing
    written)."""
    import sys
    from mrcal_tpu_torch import visualization
    computed = []
    data = visualization._distortion_off_pinhole_data
    monkeypatch.setattr(visualization, "_distortion_off_pinhole_data",
                        lambda *a, **kw: computed.append(1) or data(*a, **kw))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        mrcal_tpu_torch.show_distortion_off_pinhole(
            viz[0]["m0"], gridn_width=4, device="cpu")
    assert computed == [1]
