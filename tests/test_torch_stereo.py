"""The port's stereo module against the JAX package's, on the CPU:
rectified_resolution (LATLON, LONLAT, PINHOLE), rectified_system (LATLON
and PINHOLE; az0 given, derived and clamped away from the baseline;
return_metadata; each exception's message), rectification_maps (2 float32
ulps), stereo_range (both models, every validity bound, integer and
float32 disparities, qrect0; float64 as the JAX result) and
stereo_unproject (1e-12 relative), match_feature (found, from H10, and
None at the window's edge; q1 to 1e-9 px) and stereo_matching_ncc: the
same disparity wherever the best score beats the second by more than
1e-5, and at most 0.1 % of the pixels otherwise; bit-equal on 8-bit
images."""

import numpy as np
import pytest
import torch

import mrcal_tpu_torch
import mrcal_tpu_torch.stereo as tst

from jax_references import (_R_from_r, dense_call, dense_references,
                            dense_texture, jax_reference_pool)
from test_torch_residuals import torch_threads  # noqa: F401

LATLON = dict(az_fov_deg=40, el_fov_deg=30)
PINHOLE = dict(LATLON, rectification_model="LENSMODEL_PINHOLE")
R_CAM0_RECT0 = _R_from_r(np.array([0.02, -0.05, 0.03]))
PAIR = ("pair", "cam0", "cam1")
SKEW = ("pair", "cam0", "skew1")
RANGE_SHAPE = (40, 50)


def _disparity(seed, scale=1):
    d = np.random.default_rng(seed).uniform(-2, 30, RANGE_SHAPE)
    return (d * scale).astype(np.int16 if scale > 1 else np.float32)


def _qrect0():
    rng = np.random.default_rng(8)
    return np.stack([rng.uniform(0, 140, RANGE_SHAPE),
                     rng.uniform(0, 100, RANGE_SHAPE)], axis=-1)


def _match_images():
    tex = dense_texture((140, 200), 21, blur=1.5)
    return tex[10:130, 10:170], tex[12:132, 17:177]


def _cases():
    out = {}
    for model in ("LENSMODEL_LATLON", "LENSMODEL_LONLAT",
                  "LENSMODEL_PINHOLE"):
        for k, ppd in (("scaled", {}),
                       ("given", dict(pixels_per_deg_az=3.0,
                                      pixels_per_deg_el=-0.5))):
            out["resolution", model, k] = (
                "rectified_resolution", (("model", "cam0"),),
                dict(LATLON, az0_deg=5.0, el0_deg=-3.0,
                     R_cam0_rect0=R_CAM0_RECT0, rectification_model=model,
                     **ppd))
    for name, kw in (("latlon", LATLON), ("pinhole", PINHOLE)):
        out["system", name, "derived"] = ("rectified_system", (PAIR,),
                                          dict(kw, return_metadata=True))
        out["system", name, "given"] = ("rectified_system", (PAIR,),
                                        dict(kw, az0_deg=3.0, el0_deg=2.0))
        out["system", name, "clamped"] = (
            "rectified_system", (SKEW,),
            dict(kw, az_fov_deg=100, return_metadata=True))
        out["system", name, "ppd"] = (
            "rectified_system", (PAIR,),
            dict(kw, pixels_per_deg_az=2.5, pixels_per_deg_el=-0.7))
    out["raises", "model"] = ("rectified_system", (PAIR,),
                              dict(LATLON,
                                   rectification_model="LENSMODEL_LONLAT"))
    out["raises", "three"] = ("rectified_system",
                              (("pair", "cam0", "cam1", "skew1"),), LATLON)
    out["raises", "fov"] = ("rectified_system", (PAIR,),
                            dict(az_fov_deg=0, el_fov_deg=30))
    out["raises", "az0"] = ("rectified_system", (PAIR,),
                            dict(LATLON, az_fov_deg=60, az0_deg=70))
    out["raises", "wide"] = ("rectified_system", (SKEW,),
                             dict(LATLON, az_fov_deg=170))
    for name, kw in (("latlon", LATLON), ("pinhole", PINHOLE)):
        out["maps", name] = ("rectification_maps",
                             (PAIR, ("rect", "cam0", "cam1", kw)), {})
        # ranging sees only the rectified pair: PINHOLE cameras spare the
        # JAX references the OPENCV8 compiles
        rect = ("rect", "pin0", "pin1", kw)
        out["range", name] = ("stereo_range", (_disparity(1), rect), {})
        out["range", name, "bounds"] = (
            "stereo_range", (_disparity(2), rect),
            dict(disparity_min=3.0, disparity_max=20.0))
        out["range", name, "scaled"] = (
            "stereo_range", (_disparity(3, 16), rect),
            dict(disparity_scale=16, disparity_scaled_min=40,
                 disparity_scaled_max=400))
        out["range", name, "qrect0"] = (
            "stereo_range", (_disparity(4), rect), dict(qrect0=_qrect0()))
        out["unproject", name] = ("stereo_unproject",
                                  (_disparity(5), rect), {})
        out["unproject", name, "ranges"] = (
            "stereo_unproject", (None, rect),
            dict(ranges=np.abs(_disparity(6)), qrect0=_qrect0()))
    im0, im1 = _match_images()
    kw = dict(search_radius1=10, template_size1=11)
    out["match", "found"] = ("match_feature", (im0, im1, [80.0, 60.0]), kw)
    out["match", "estimate"] = ("match_feature", (im0, im1, [80.3, 50.7]),
                                dict(kw, q1_estimate=[73.0, 58.0]))
    out["match", "H10"] = ("match_feature", (im0, im1, [60.2, 70.9]),
                           dict(kw, H10=np.array([[1.0, 0.01, -7.5],
                                                  [0.0, 1.0, -1.8],
                                                  [0.0, 1e-5, 1.0]])))
    out["match", "edge"] = ("match_feature", (im0, im1, [80.0, 60.0]),
                            dict(kw, search_radius1=3))
    for name, (a, b) in (("float", _match_images()),
                         ("uint8", [np.clip(np.round(x / 4), 0, 255)
                                    .astype(np.uint8)
                                    for x in _match_images()])):
        out["ncc", name] = ("stereo_matching_ncc", (a, b),
                            dict(disparity_min=2, disparity_max=24,
                                 block_size=9))
    return out


CASES = _cases()


@pytest.fixture(scope="module")
def jax_refs():
    # five processes, all started at once: the JAX package's first
    # OPENCV8 rectified_system costs each process that makes one ~9 s of
    # compiles, so those cases are spread over three
    def group(k):
        if k[0] == "maps":
            return f"maps {k[1]}"
        return dict(resolution="system", raises="system",
                    unproject="range", ncc="match").get(k[0], k[0])
    groups = sorted({group(k) for k in CASES})
    with jax_reference_pool(len(groups), compiled=False) as pool:
        futures = [pool.submit(dense_references,
                               {k: c for k, c in CASES.items()
                                if group(k) == g})
                   for g in groups]
        refs = {}
        for f in futures:
            refs.update(f.result(timeout=600))
        yield refs


def _port(name):
    return dense_call(mrcal_tpu_torch, CASES[name], dict(device="cpu"))


def _names(group):
    return [k for k in CASES if k[0] == group]


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max(initial=0) <= \
        rtol * np.abs(want).max(initial=1e-300)


@pytest.mark.parametrize("name", _names("resolution"), ids=str)
def test_rectified_resolution_matches_jax(jax_refs, name):
    got, want = _port(name), jax_refs[name]
    assert _close(got, want, 1e-12)


def _same_model(got, want, rtol=1e-12):
    assert got["lensmodel"] == want["lensmodel"]
    assert np.array_equal(got["imagersize"], want["imagersize"])
    assert _close(got["intrinsics"], want["intrinsics"], rtol)
    assert np.abs(got["rt_cam_ref"] - want["rt_cam_ref"]).max() <= 1e-12


@pytest.mark.parametrize("name", _names("system"), ids=str)
def test_rectified_system_matches_jax(jax_refs, name):
    got, want = _port(name), jax_refs[name]
    if CASES[name][2].get("return_metadata"):
        (got, meta), (want, meta_want) = got, want
        assert meta.keys() == meta_want.keys()
        for k in meta:
            assert abs(meta[k] - meta_want[k]) <= 1e-12 * abs(meta_want[k])
    for g, w in zip(got, want):
        _same_model(g, w)
    if name[2] == "clamped":
        # the derived az0 (45 degrees) is pulled in to 90 - 10 - 50
        assert meta["az0_deg"] == pytest.approx(30.0, abs=1e-12)


@pytest.mark.parametrize("name", _names("raises"), ids=str)
def test_rectified_system_raises_as_jax(jax_refs, name):
    got, want = _port(name), jax_refs[name]
    assert want[0] == "raises"
    assert got == want


@pytest.mark.parametrize("name", _names("maps"), ids=str)
def test_rectification_maps_match_jax(jax_refs, name):
    got, want = _port(name), jax_refs[name]
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape and got.shape[0] == 2
    assert np.all(np.abs(got - want) <= 2 * np.spacing(np.abs(want)))


@pytest.mark.parametrize("name", _names("range") + _names("unproject"),
                         ids=str)
def test_range_and_unproject_match_jax(jax_refs, name):
    got, want = _port(name), jax_refs[name]
    assert got.dtype == want.dtype == np.float64
    assert _close(got, want, 1e-12)
    if name[0] == "range":
        # the same pixels are valid
        assert np.array_equal(got == 0, want == 0)
        assert 0 < (want > 0).mean() < 1


def test_range_and_points_are_tensors():
    m0, m1 = (mrcal_tpu_torch.cameramodel(
        intrinsics=("LENSMODEL_PINHOLE", [150.0, 150.0, 79.5, 59.5]),
        imagersize=(160, 120), rt_cam_ref=rt)
        for rt in (np.zeros(6), np.array([0., 0., 0., -0.2, 0., 0.])))
    models = mrcal_tpu_torch.rectified_system((m0, m1), **LATLON,
                                              device="cpu")
    disp = torch.full(RANGE_SHAPE, 4.0)
    r = mrcal_tpu_torch.stereo_range(disp, models, device="cpu")
    p = mrcal_tpu_torch.stereo_unproject(disp, models, device="cpu")
    assert torch.is_tensor(r) and r.dtype == torch.float64
    assert torch.is_tensor(p) and p.shape == RANGE_SHAPE + (3,)
    assert torch.allclose(torch.linalg.vector_norm(p, dim=-1), r)


@pytest.mark.parametrize("name", _names("match"), ids=str)
def test_match_feature_matches_jax(jax_refs, name):
    (q1, diag), (q1_want, diag_want) = _port(name), jax_refs[name]
    assert diag.keys() == diag_want.keys()
    assert _close(diag["matchoutput_image"], diag_want["matchoutput_image"],
                  1e-12)
    if name[1] == "edge":
        assert q1 is None and q1_want is None
        return
    assert isinstance(q1, np.ndarray) and q1.dtype == np.float64
    assert np.abs(q1 - q1_want).max() <= 1e-9
    assert abs(diag["score"] - diag_want["score"]) <= 1e-12


@pytest.mark.parametrize("name", _names("ncc"), ids=str)
def test_ncc_matches_jax(jax_refs, name):
    got, want = _port(name), jax_refs[name]
    assert isinstance(got, np.ndarray)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    a, b = (np.asarray(x, np.float32) for x in CASES[name][1])
    kw = CASES[name][2]
    scores = tst._ncc_scores(torch.as_tensor(a), torch.as_tensor(b),
                             kw["disparity_min"], kw["disparity_max"],
                             kw["block_size"])[0]
    top2 = torch.topk(scores, 2, dim=0).values
    clear = (top2[0] - top2[1] > 1e-5).numpy()
    # the subpixel fits of the same best disparity differ by the scores'
    # roundoff over the parabola's curvature
    differ = np.abs(got - want) > 1e-2
    assert not differ[clear].any()
    assert differ.mean() <= 1e-3
    assert (want > 0).mean() > 0.5
    if name[1] == "uint8":
        # exact window sums, and square roots correctly rounded
        assert np.array_equal(got, want)
