"""The port's image module against the JAX package's: file round trips
(8-bit and 16-bit gray, BGR; each package reads what the other wrote),
the colormap (a torch op on the given device) and the two equalizations,
on the CPU."""

import numpy as np
import pytest
import torch

import mrcal_tpu.image as jimage
import mrcal_tpu_torch
import mrcal_tpu_torch.image as timage

from test_torch_residuals import torch_threads  # noqa: F401


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _image(rng, kind):
    if kind == "gray8":
        return rng.integers(0, 256, (11, 17), dtype=np.uint8), {}
    if kind == "gray16":
        return rng.integers(0, 65536, (11, 17), dtype=np.uint16), dict(
            bits_per_pixel=16, channels=1)
    return rng.integers(0, 256, (11, 17, 3), dtype=np.uint8), {}


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("kind,ext", [("gray8", "png"), ("gray8", "pgm"),
                                      ("gray16", "png"), ("gray16", "pgm"),
                                      ("bgr", "png"), ("bgr", "ppm")])
def test_roundtrip_matches_jax(tmp_path, rng, kind, ext, writer):
    a, load_kw = _image(rng, kind)
    f = str(tmp_path / f"im.{ext}")
    (timage if writer == "port" else jimage).save_image(f, a)
    b_t = timage.load_image(f, **load_kw)
    b_j = jimage.load_image(f, **load_kw)
    assert b_t.dtype == b_j.dtype == a.dtype
    assert np.array_equal(b_t, a)
    assert np.array_equal(b_t, b_j)


@pytest.mark.parametrize("load_kw", [dict(channels=1),
                                     dict(bits_per_pixel=8, channels=1),
                                     dict(bits_per_pixel=16, channels=1)])
def test_conversions_match_jax(tmp_path, rng, load_kw):
    """Color read as gray, 16-bit read as 8-bit and 8-bit as 16-bit."""
    for a in (rng.integers(0, 256, (9, 9, 3), dtype=np.uint8),
              rng.integers(0, 65536, (9, 9), dtype=np.uint16),
              rng.integers(0, 256, (9, 9), dtype=np.uint8)):
        f = str(tmp_path / "c.png")
        jimage.save_image(f, a)
        b_t = timage.load_image(f, **load_kw)
        b_j = jimage.load_image(f, **load_kw)
        assert b_t.dtype == b_j.dtype and np.array_equal(b_t, b_j)


def test_save_takes_a_tensor(tmp_path, rng):
    a = rng.integers(0, 256, (5, 7), dtype=np.uint8)
    f = str(tmp_path / "t.png")
    timage.save_image(f, torch.as_tensor(a))
    assert np.array_equal(jimage.load_image(f, channels=1), a)


@pytest.mark.parametrize("limits", [dict(), dict(a_min=0.2, a_max=0.7),
                                    dict(a_min=-1.0)])
def test_color_map_matches_jax(rng, limits):
    im = rng.normal(size=(23, 31)) * 3
    im[4, 5] = np.nan
    want = jimage.apply_color_map(np.nan_to_num(im), **limits)
    got = timage.apply_color_map(np.nan_to_num(im), device="cpu", **limits)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), want)
    # NaN is ignored when the extremes are taken
    got = timage.apply_color_map(im, device="cpu")
    lo, hi = np.nanmin(im), np.nanmax(im)
    assert np.array_equal(
        got.numpy()[np.isfinite(im)],
        jimage.apply_color_map(im, a_min=lo, a_max=hi)[np.isfinite(im)])


def test_color_map_shape():
    im = np.linspace(0.0, 1.0, 7)[None, :]
    out = mrcal_tpu_torch.apply_color_map(im, a_min=0.0, a_max=1.0,
                                          device="cpu").numpy()
    assert out.dtype == np.uint8 and out.shape == (1, 7, 3)
    # BGR: low values blue-dominant, high values red-dominant
    assert out[0, 0, 0] > out[0, 0, 2]
    assert out[0, -1, 2] > out[0, -1, 0]


@pytest.mark.parametrize("fn", ["clahe_equalize", "stretch_equalize"])
def test_equalization_matches_jax(rng, fn):
    im = rng.normal(100, 30, (40, 56)).clip(0, 255)
    assert np.array_equal(getattr(timage, fn)(im), getattr(jimage, fn)(im))
