"""The port's chessboard detector against the JAX package's, on the CPU:
the ChESS response bit for bit on 8-bit renders (and on float ones), the
local maxima, the subpixel fit, the batched saddle refinement against
the JAX package's per-corner loop at each of its exits, the grid
ordering, and find_chessboard_corners on the scenes of
tests/test_detector.py and on noisy ones found at pyramid levels 1 and 2:
the same level, corners within 1e-9 px.  Where the JAX package numbers a
square grid as the board's mirror image, the port's corners are its
corners transposed (test_square_grid_is_not_mirrored)."""

import numpy as np
import pytest
import torch

import mrcal_tpu.detector as jd
import mrcal_tpu_torch
import mrcal_tpu_torch.detector as td

from jax_references import (detector_references, detector_scene,
                            jax_reference_pool)
from test_detector import grid_match_error, render_chessboard
from test_torch_residuals import torch_threads  # noqa: F401

CORNER_TOL = 1e-9


SCENES = ["frontal", "perspective", "noise_blobs", "nonsquare",
          "noisy_level1", "noisy_level2", "mirrored"]


RESPONSES = ["frontal", "perspective", "noise_blobs"]
# the JAX references, in as many processes started at once (each pays the
# eager compiles of chess_response's operations at its images' shapes)
CHILDREN = [(["frontal", "perspective", "mirrored"],
             ["frontal", "perspective"]),
            (["noise_blobs"], ["noise_blobs"]),
            (["nonsquare"], []),
            (["noisy_level1", "noisy_level2"], [])]


FILES = ["frontal", "perspective"]


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    """8-bit PNG files of FILES, frame{i:03d}-cam0.png."""
    from mrcal_tpu.image import save_image
    d = tmp_path_factory.mktemp("images")
    paths = []
    for i, name in enumerate(FILES):
        paths.append(str(d / f"frame{i:03d}-cam0.png"))
        save_image(paths[-1], np.clip(detector_scene(name)[0], 0, 255)
                   .astype(np.uint8))
    return paths


@pytest.fixture(scope="module")
def jax_refs(image_files):
    with jax_reference_pool(len(CHILDREN), compiled=False) as pool:
        futures = [pool.submit(detector_references, *c,
                               image_files if i == 0 else [])
                   for i, c in enumerate(CHILDREN)]
        refs = {}
        for f in futures:
            refs.update(f.result(timeout=600))
        yield refs


@pytest.mark.parametrize("as_uint8", [True, False], ids=["uint8", "float32"])
@pytest.mark.parametrize("name", RESPONSES)
def test_chess_response_matches_jax(jax_refs, name, as_uint8):
    """Bit for bit on 8-bit images (every term but /5 is exact there);
    within one ulp on float32 ones."""
    im = detector_scene(name)[0]
    if as_uint8:
        im = np.clip(im, 0, 255).astype(np.uint8)
    want = jax_refs["response", name, "uint8" if as_uint8 else "float32"]
    got = td.chess_response(im, device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    got = got.numpy()
    if as_uint8:
        assert np.array_equal(got, want)
    else:
        assert np.all(np.abs(got - want) <= np.spacing(np.abs(want)))


def test_chess_response_takes_a_stack(jax_refs):
    """A stack of images gives each image's response."""
    ims = [np.clip(detector_scene(n)[0][:440, :440], 0, 255).astype(np.uint8)
           for n in ("frontal", "perspective", "noise_blobs")]
    got = td.chess_response(torch.as_tensor(np.stack(ims)), device="cpu")
    assert np.array_equal(got[2].numpy(),
                          jax_refs["response", "noise_blobs", "uint8"])
    for im, R in zip(ims, got):
        assert np.array_equal(R.numpy(), td.chess_response(
            im, device="cpu").numpy())


def _unmirrored(det, gridn_w, gridn_h):
    """The JAX package's grid as the port orders it: a square grid whose
    rows run along the image's y (the board's mirror image) transposed,
    then flipped as the JAX package flips (rows along +x, columns along
    +y)."""
    g = det.reshape(gridn_h, gridn_w, 2)
    row_dir = (g[:, -1] - g[:, 0]).mean(axis=0)
    if gridn_w != gridn_h or abs(row_dir[0]) >= abs(row_dir[1]):
        return det
    g = g.transpose(1, 0, 2)
    if (g[:, -1] - g[:, 0]).mean(axis=0)[0] < 0:
        g = g[:, ::-1]
    if (g[-1] - g[0]).mean(axis=0)[1] < 0:
        g = g[::-1]
    return g.reshape(-1, 2)


@pytest.mark.parametrize("name", SCENES)
def test_find_chessboard_corners_matches_jax(jax_refs, name):
    """The JAX package's corners and level; square grids that it numbers
    as the board's mirror image (perspective, noise_blobs, the noisy ones
    and mirrored) in the port's order."""
    im, grid = detector_scene(name)
    det_j, level_j = jax_refs["corners", name]
    det_t, level_t = mrcal_tpu_torch.find_chessboard_corners(
        im, *grid, device="cpu")
    assert det_j is not None and level_t == level_j
    assert det_t.shape == det_j.shape == (grid[0] * grid[1], 2)
    assert np.abs(det_t - _unmirrored(det_j, *grid)).max() <= CORNER_TOL
    if name.startswith("noisy_level"):
        assert level_t == int(name[-1])


def test_square_grid_is_not_mirrored(jax_refs):
    """The mirrored scene: the port's corners are the board's in its own
    order (rows along +x), the JAX package's are its mirror image."""
    Hmat = np.array([[25.0, 5.0, 85.0], [-5.0, 25.0, 90.0],
                     [4e-5, -3e-5, 1.0]])
    im, corners = render_chessboard(440, 460, Hmat)
    det, _ = td.find_chessboard_corners(im, 10, 10, device="cpu")
    assert np.abs(det - corners.reshape(-1, 2)).max() < 0.1
    det_j = jax_refs["corners", "mirrored"][0]
    assert np.abs(det_j - corners.reshape(-1, 2)).max() > 100
    assert np.abs(det_j.reshape(10, 10, 2).transpose(1, 0, 2)[:, ::-1]
                  - corners).max() < 0.1


def test_detected_grid_is_accurate():
    """The port's own gate of tests/test_detector.py: the frontal board's
    corners within 0.2 px of the truth, row-major along +x then +y."""
    Hmat = np.array([[30.0, 0.0, 70.0], [0.0, 30.0, 55.0], [0.0, 0.0, 1.0]])
    im, corners = render_chessboard(450, 480, Hmat)
    det, level = td.find_chessboard_corners(im, 10, 10, device="cpu")
    assert level == 0 and grid_match_error(det, corners) < 0.2
    g = det.reshape(10, 10, 2)
    assert np.all(np.diff(g[..., 0], axis=1) > 0)
    assert np.all(np.diff(g[..., 1], axis=0) > 0)


def test_local_maxima_and_subpixel_match_jax():
    """The plateau grouping (exact ties on a clean render) and the
    quadratic fit, candidates in the same order."""
    # vertices at half pixels: 2 x 2 plateaus of exact ties
    im = render_chessboard(300, 320, np.array(
        [[24.0, 0.0, 40.5], [0.0, 24.0, 30.5], [0.0, 0.0, 1.0]]))[0]
    # (the port's response: test_chess_response_matches_jax holds it to
    # the JAX package's bit for bit on 8-bit images)
    R = td.chess_response(np.clip(im, 0, 255).astype(np.uint8),
                          device="cpu").numpy()
    thr = 0.2 * R.max()
    xy_j, resp_j = jd._local_maxima(R, thr)
    xy_t, resp_t = td._local_maxima(torch.as_tensor(R.copy()), thr)
    assert np.array_equal(xy_t, xy_j) and np.array_equal(resp_t, resp_j)
    assert np.any(xy_j != np.round(xy_j))       # plateau centroids
    # border pixels and every candidate, with a fractional one
    xy = np.concatenate([xy_j, [[0.0, 5.0], [319.0, 200.0], [10.5, 3.5]]])
    assert np.array_equal(td._refine_subpixel(torch.as_tensor(R.copy()), xy),
                          jd._refine_subpixel(R, xy))


def _saddle_exit(im, q, halfwin, iters=8):
    """Which exit the JAX package's loop (mrcal_tpu/detector.py:167-189)
    takes from q."""
    gy, gx = np.gradient(np.asarray(im, np.float64))
    H, W = im.shape
    ys, xs = np.mgrid[-halfwin:halfwin + 1, -halfwin:halfwin + 1]
    w = np.exp(-(xs ** 2 + ys ** 2) / (2.0 * (halfwin / 2.0) ** 2))
    q = np.array(q, np.float64)
    for _ in range(iters):
        cx, cy = int(round(q[0])), int(round(q[1]))
        if not (halfwin + 1 <= cx < W - halfwin - 1
                and halfwin + 1 <= cy < H - halfwin - 1):
            return "bounds"
        sl = (slice(cy - halfwin, cy + halfwin + 1),
              slice(cx - halfwin, cx + halfwin + 1))
        gxw, gyw = gx[sl], gy[sl]
        px, py = xs + cx, ys + cy
        a, b, c = (np.sum(w * u * v) for u, v in ((gxw, gxw), (gxw, gyw),
                                                   (gyw, gyw)))
        det = a * c - b * b
        if det < 1e-12:
            return "degenerate"
        bx = np.sum(w * gxw * (gxw * px + gyw * py))
        by = np.sum(w * gyw * (gxw * px + gyw * py))
        qn = np.array([(c * bx - b * by) / det, (a * by - b * bx) / det])
        if not np.all(np.isfinite(qn)):
            return "not finite"
        if np.linalg.norm(qn - q) > halfwin:
            return "jump"
        moved = np.linalg.norm(qn - q)
        q = qn
        if moved < 1e-3:
            return "converged"
    return "iterations"


def test_refine_saddle_matches_the_jax_loop_at_each_exit():
    """Every corner of a batch against the JAX package's loop: corners that
    converge, leave the image, sit on a flat patch, meet a NaN pixel, jump
    past halfwin, or run out of iterations."""
    Hmat = np.array([[30.0, 3.0, 70.0], [-2.0, 30.0, 55.0],
                     [2e-5, 1e-5, 1.0]])
    im, corners = render_chessboard(450, 480, Hmat)
    im = im + np.random.default_rng(2).normal(0, 2.0, im.shape).astype(
        np.float32)
    im[400:420, 430:450] = np.nan
    im[5:50, 5:60] = 130.0                       # a flat patch
    rng = np.random.default_rng(3)
    q = np.concatenate([corners.reshape(-1, 2) + rng.uniform(-1, 1, (100, 2)),
                        rng.uniform(-2, [481, 451], (600, 2)),
                        [[440.0, 410.0], [3.0, 200.0], [30.0, 27.0]]])
    halfwin = 7
    exits = {_saddle_exit(im, p, halfwin) for p in q}
    assert exits == {"bounds", "degenerate", "not finite", "jump",
                     "converged", "iterations"}
    got = td._refine_saddle(torch.as_tensor(im), q, halfwin=halfwin)
    want = jd._refine_saddle(im, q, halfwin=halfwin)
    assert np.abs(got - want).max() <= CORNER_TOL


def test_order_into_grid_rejects_incomplete():
    pts = np.random.default_rng(1).uniform(0, 100, (40, 2))
    assert td._order_into_grid(pts, 10, 10) is None
    assert jd._order_into_grid(pts, 10, 10) is None
    # a whole lattice less one point
    g = np.stack(np.meshgrid(np.arange(10.), np.arange(10.)), -1) * 20 + 50
    pts = np.delete(g.reshape(-1, 2), 37, axis=0)
    assert td._order_into_grid(pts, 10, 10) is None
    assert jd._order_into_grid(pts, 10, 10) is None
    full = td._order_into_grid(g.reshape(-1, 2)[::-1].copy(), 10, 10)
    assert np.array_equal(full, g.reshape(-1, 2))


def test_detect_corners_in_images_matches_jax(jax_refs, image_files,
                                             tmp_path):
    """The files' corners and levels; a blank image gives None."""
    from mrcal_tpu.image import save_image
    want = jax_refs["files"]
    got = mrcal_tpu_torch.detect_corners_in_images(image_files, 10,
                                                   device="cpu")
    assert list(got) == image_files == list(want)
    for p in image_files:
        assert got[p][:, 2].tolist() == want[p][:, 2].tolist()
        assert np.abs(got[p][:, :2] - _unmirrored(want[p][:, :2], 10, 10)
                      ).max() <= CORNER_TOL
    blank = str(tmp_path / "blank.png")
    save_image(blank, np.full((60, 80), 128, np.uint8))
    assert mrcal_tpu_torch.detect_corners_in_images(
        [blank], 10, device="cpu") == {blank: None}
