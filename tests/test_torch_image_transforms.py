"""The port's image_transforms against the JAX package's, on the CPU: every
fit of scale_focal__best_pinhole_fit and pinhole_model_for_reprojection
(1e-12); image_transformation_map from OPENCV8 to PINHOLE with the
intrinsics only, a rotation, a distance, a plane and the valid-intrinsics
mask (2 float32 ulps); transform_image on float32 (1e-6 of the image's
largest value), float64 (1e-12 of it), uint8 and uint16 (equal but for at
most 0.1 % of the pixels, by one level), 3-channel images, out= and a map
whose samples all lie on .5 of a level (rounded half away from zero, as
the JAX package's map_coordinates)."""

import numpy as np
import pytest
import torch

import mrcal_tpu_torch
import mrcal_tpu_torch.image_transforms as ti

from jax_references import (dense_call, dense_references, dense_texture,
                            half_level_case, jax_reference_pool,
                            remap_coordinates)
from test_torch_residuals import torch_threads  # noqa: F401

FITS = {"none": None, "corners": "corners",
        "centers-horizontal": "centers-horizontal",
        "centers-vertical": "centers-vertical",
        "points": np.array([[10.0, 20.0], [150.0, 100.0], [3.0, 115.0]])}
MAPS = {"intrinsics_only": dict(intrinsics_only=True),
        "rotation": {},
        "distance": dict(distance=2.0),
        "plane": dict(plane_n=np.array([0.1, -0.05, 1.0]), plane_d=2.0)}


def _image(kind):
    tex = dense_texture((120, 160), 3)
    if kind == "float32":
        return tex
    if kind == "float64":
        return tex.astype(np.float64) * 1e-3
    if kind == "uint8":
        return np.clip(tex / 4, 0, 255).astype(np.uint8)
    if kind == "uint16":
        return np.clip(tex * 64, 0, 65535).astype(np.uint16)
    if kind == "rgb":
        return np.clip(tex[..., None] * [0.2, 0.25, 0.3], 0, 255).astype(
            np.uint8)
    raise ValueError(kind)


IMAGES = ["float32", "float64", "uint8", "uint16", "rgb"]


def _cases():
    out = {}
    for k, fit in FITS.items():
        out["scale", k] = ("scale_focal__best_pinhole_fit",
                           (("model", "cam0"), fit), {})
    out["pinhole", "scale_image"] = (
        "pinhole_model_for_reprojection", (("model", "cam0"), "corners"),
        dict(scale_image=0.5))
    out["pinhole", "scale_focal"] = (
        "pinhole_model_for_reprojection", (("model", "cam1"),),
        dict(scale_focal=0.8, scale_image=1.25))
    for k, kw in MAPS.items():
        out["map", k] = ("image_transformation_map",
                         (("model", "cam1"), ("pinhole", "cam0", "corners")),
                         kw)
    out["map", "mask"] = ("image_transformation_map",
                          (("model", "cam1_region"),
                           ("pinhole", "cam0", "centers-horizontal")),
                          dict(mask_valid_intrinsics_region_from=True))
    mapxy = remap_coordinates((100, 140), 4)
    for kind in IMAGES:
        out["remap", kind] = ("transform_image", (_image(kind), mapxy), {})
    out["remap", "float64_map"] = ("transform_image",
                                   (_image("uint8"),
                                    mapxy.astype(np.float64)), {})
    out["remap", "half"] = ("transform_image", half_level_case(), {})
    return out


CASES = _cases()


@pytest.fixture(scope="module")
def jax_refs():
    # one process for each group of cases, all started at once
    groups = sorted({k[0] for k in CASES})
    with jax_reference_pool(len(groups), compiled=False) as pool:
        futures = [pool.submit(dense_references,
                               {k: c for k, c in CASES.items() if k[0] == g})
                   for g in groups]
        refs = {}
        for f in futures:
            refs.update(f.result(timeout=600))
        yield refs


def _port(name):
    return dense_call(mrcal_tpu_torch, CASES[name], dict(device="cpu"))


@pytest.mark.parametrize("fit", list(FITS))
def test_scale_focal_matches_jax(jax_refs, fit):
    got, want = _port(("scale", fit)), jax_refs["scale", fit]
    assert isinstance(got, float)
    assert abs(got - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize("case", ["scale_image", "scale_focal"])
def test_pinhole_model_matches_jax(jax_refs, case):
    got, want = _port(("pinhole", case)), jax_refs["pinhole", case]
    assert got["lensmodel"] == want["lensmodel"] == "LENSMODEL_PINHOLE"
    assert np.array_equal(got["imagersize"], want["imagersize"])
    assert np.allclose(got["intrinsics"], want["intrinsics"], rtol=1e-12,
                       atol=0)
    assert np.array_equal(got["rt_cam_ref"], want["rt_cam_ref"])


def _within_ulps(got, want, n):
    return np.all(np.abs(got - want) <= n * np.spacing(np.abs(want)))


@pytest.mark.parametrize("case", list(MAPS) + ["mask"])
def test_transformation_map_matches_jax(jax_refs, case):
    got, want = _port(("map", case)), jax_refs["map", case]
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (120, 160, 2)
    assert _within_ulps(got, want, 2)
    if case == "mask":
        masked = np.all(want == -1.0, axis=-1)
        assert 0.05 < masked.mean() < 0.9
        assert np.array_equal(np.all(got == -1.0, axis=-1), masked)


@pytest.mark.parametrize("kind", IMAGES + ["float64_map"])
def test_transform_image_matches_jax(jax_refs, kind):
    got, want = _port(("remap", kind)), jax_refs["remap", kind]
    assert isinstance(got, np.ndarray)
    assert got.dtype == want.dtype and got.shape == want.shape
    image = CASES["remap", kind][1][0]
    assert got.shape[:2] == (100, 140) and got.shape[2:] == image.shape[2:]
    if got.dtype == np.float32:
        assert np.abs(got - want).max() <= 1e-6 * np.abs(image).max()
    elif got.dtype == np.float64:
        assert np.abs(got - want).max() <= 1e-12 * np.abs(image).max()
    else:
        diff = np.abs(got.astype(np.int64) - want)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    # the masked (-1, -1) entries and the samples past the edges
    mapxy = CASES["remap", kind][1][1]
    assert np.all(want[np.all(mapxy == -1.0, axis=-1)] == 0)


def test_transform_image_rounds_half_away_from_zero(jax_refs):
    """Every sample is k + 0.5: JAX rounds each up, round-half-to-even
    would take half of them down."""
    got, want = _port(("remap", "half")), jax_refs["remap", "half"]
    assert got.dtype == np.uint8
    assert np.array_equal(got, want)
    im, mapxy = half_level_case()
    exact = (im[:, :-1].astype(np.float64) + im[:, 1:]) / 2
    assert np.all(exact % 1 == 0.5)
    assert np.array_equal(want, np.ceil(exact))
    assert not np.array_equal(want, np.round(exact))


def test_transform_image_out_and_tensors():
    im = _image("rgb")
    mapxy = remap_coordinates((100, 140), 4)
    want = ti.transform_image(im, mapxy, device="cpu")
    out = np.zeros_like(want)
    assert ti.transform_image(im, mapxy, out=out, device="cpu") is out
    assert np.array_equal(out, want)
    got = ti.transform_image(torch.as_tensor(im), torch.as_tensor(mapxy),
                             device="cpu")
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_fit_rejects_unknown_name():
    m = mrcal_tpu_torch.cameramodel(intrinsics=("LENSMODEL_PINHOLE",
                                                [100., 100., 50., 40.]),
                                    imagersize=(100, 80))
    with pytest.raises(Exception, match="Unknown fit='diagonal'"):
        ti.scale_focal__best_pinhole_fit(m, "diagonal", device="cpu")
