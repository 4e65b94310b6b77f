"""Stereo rectification, ranging and block matching.

Counterpart of ``mrcal_tpu/stereo.py``.  ``rectified_resolution`` and
``rectified_system`` are host numpy on the port's projections;
``rectification_maps`` unprojects the rectified grid once in float64 on
the entry point's device, rotates it into each camera and projects it
there.  ``stereo_range`` and ``stereo_unproject`` are closed forms on the
device and return tensors; ``match_feature`` scores every offset of its
search window in one batched float64 gather and finds the peak on the
host; ``stereo_matching_ncc`` builds its (Nd, H, W) float32 score volume
in chunks of disparities.  The maps, the NCC disparity and the feature
match come back as numpy, as in the JAX package.
"""

import numpy as np
import torch

from ._config import resolve_device
from .cameramodel import _host
from .image_transforms import _map_coordinates, _pixel_grid
from .model_analysis import _intrinsics
from . import poseutils as _pose
from .projections import (_project, _unproject, project, unproject_latlon,
                          unproject_lonlat, unproject_pinhole)

# disparities per chunk of stereo_matching_ncc's score volume
NCC_CHUNK = 32


def _numpy(*tensors):
    return tuple(t.cpu().numpy() for t in tensors)


def rectified_resolution(model0, *, az_fov_deg, el_fov_deg,
                         az0_deg, el0_deg, R_cam0_rect0,
                         pixels_per_deg_az=-1., pixels_per_deg_el=-1.,
                         rectification_model='LENSMODEL_LATLON',
                         device=None):
    """Resolution for the rectified system (reference: stereo.py:118).
    pixels_per_deg < 0 means 'that scale factor of the input resolution at
    the rectified center'."""
    if pixels_per_deg_az < 0 or pixels_per_deg_el < 0:
        azel0 = np.array((az0_deg, el0_deg)) * np.pi / 180.
        if rectification_model == 'LENSMODEL_LATLON':
            vrect, dvrect_dazel = _numpy(*unproject_latlon(
                azel0, get_gradients=True, device=device))
        elif rectification_model == 'LENSMODEL_LONLAT':
            vrect, dvrect_dazel = _numpy(*unproject_lonlat(
                azel0, get_gradients=True, device=device))
        elif rectification_model == 'LENSMODEL_PINHOLE':
            qn = np.tan(azel0)
            vrect, dv_dqn = _numpy(*unproject_pinhole(
                qn, get_gradients=True, device=device))
            cos_azel0 = np.cos(azel0)
            dvrect_dazel = dv_dqn / (cos_azel0 * cos_azel0)
        else:
            raise Exception("Unsupported rectification model")
        v0 = np.asarray(R_cam0_rect0) @ vrect
        dv0_dazel = np.asarray(R_cam0_rect0) @ dvrect_dazel
        _, dq_dv0, _ = _numpy(*project(v0, *model0.intrinsics(),
                                       get_gradients=True, device=device))
        dq_dazel = dq_dv0 @ dv0_dazel
        if pixels_per_deg_az < 0:
            have = np.linalg.norm(dq_dazel[:, 0]) * np.pi / 180.
            pixels_per_deg_az = -pixels_per_deg_az * have
        if pixels_per_deg_el < 0:
            have = np.linalg.norm(dq_dazel[:, 1]) * np.pi / 180.
            pixels_per_deg_el = -pixels_per_deg_el * have

    if rectification_model in ('LENSMODEL_LATLON', 'LENSMODEL_LONLAT'):
        # fit integer pixel counts in the fov
        Naz = round(az_fov_deg * pixels_per_deg_az)
        Nel = round(el_fov_deg * pixels_per_deg_el)
        pixels_per_deg_az = Naz / az_fov_deg
        pixels_per_deg_el = Nel / el_fov_deg
    return pixels_per_deg_az, pixels_per_deg_el


def rectified_system(models, *, az_fov_deg, el_fov_deg,
                     az0_deg=None, el0_deg=0,
                     az_edge_margin_deg=10.,
                     pixels_per_deg_az=-1., pixels_per_deg_el=-1.,
                     rectification_model='LENSMODEL_LATLON',
                     return_metadata=False, device=None):
    """Build the epipolar-aligned rectified camera pair (reference:
    stereo.py:486 _rectified_system_python / stereo.c:390)."""
    from .cameramodel import cameramodel
    if rectification_model not in ('LENSMODEL_LATLON', 'LENSMODEL_PINHOLE'):
        raise Exception(f"Unsupported rectification model "
                        f"'{rectification_model}'")
    if len(models) != 2:
        raise Exception("I need exactly 2 camera models")
    if az_fov_deg is None or el_fov_deg is None or \
       az_fov_deg <= 0 or el_fov_deg <= 0:
        raise Exception("az_fov_deg, el_fov_deg must be > 0")

    Rt01 = _host(_pose.compose_Rt, models[0].Rt_cam_ref(),
                 models[1].Rt_ref_cam())

    # rectified axes in cam0 coords: right = baseline direction, forward =
    # mean optical axis orthogonalized, down completes
    right = Rt01[3, :].copy()
    baseline = np.linalg.norm(right)
    right /= baseline
    forward0 = np.array((0, 0, 1.))
    forward1 = Rt01[:3, 2]
    forward01 = forward0 + forward1
    forward01_proj_right = np.dot(forward01, right)
    forward = forward01 - forward01_proj_right * right
    forward /= np.linalg.norm(forward)
    down = np.cross(forward, right)
    R_rect0_cam0 = np.stack([right, down, forward], axis=0)

    margin_loose = az_edge_margin_deg - 1e-3
    if az0_deg is not None:
        az0 = az0_deg * np.pi / 180.
        if not (az0_deg - az_fov_deg / 2. > -90. + margin_loose and
                az0_deg + az_fov_deg / 2. < 90. - margin_loose):
            raise Exception("rectified view looks along the baseline; "
                            "reduce az_fov_deg or adjust az0_deg")
    else:
        az0 = np.arcsin(forward01_proj_right / np.linalg.norm(forward01))
        az0_deg = az0 * 180. / np.pi
        if not (az0_deg - az_fov_deg / 2. > -90. + margin_loose and
                az0_deg + az_fov_deg / 2. < 90. - margin_loose):
            if az_fov_deg > 180. - 2. * az_edge_margin_deg:
                raise Exception("az_fov_deg too large to avoid the baseline")
            if not (az0_deg - az_fov_deg / 2. > -90. + margin_loose):
                az0_deg = -90. + az_edge_margin_deg + az_fov_deg / 2.
            else:
                az0_deg = 90. - az_edge_margin_deg - az_fov_deg / 2.
            az0 = az0_deg / 180. * np.pi
    el0 = el0_deg * np.pi / 180.

    pixels_per_deg_az, pixels_per_deg_el = rectified_resolution(
        models[0], az_fov_deg=az_fov_deg, el_fov_deg=el_fov_deg,
        az0_deg=az0_deg, el0_deg=el0_deg,
        R_cam0_rect0=R_rect0_cam0.T,
        pixels_per_deg_az=pixels_per_deg_az,
        pixels_per_deg_el=pixels_per_deg_el,
        rectification_model=rectification_model, device=device)

    fxycxy = np.array((pixels_per_deg_az / np.pi * 180.,
                       pixels_per_deg_el / np.pi * 180., 0., 0.))
    if rectification_model == 'LENSMODEL_LATLON':
        Naz = round(az_fov_deg * pixels_per_deg_az)
        Nel = round(el_fov_deg * pixels_per_deg_el)
        fxycxy[2:] = (np.array(((Naz - 1.) / 2., (Nel - 1.) / 2.)) -
                      np.array((az0, el0)) * fxycxy[:2])
    else:
        # pinhole rectification (reference: stereo.py:684-716)
        cos_az0 = np.cos(az0)
        cos_el0 = np.cos(el0)
        fxycxy[0] *= cos_az0 * cos_az0
        fxycxy[1] *= cos_el0 * cos_el0

        def cxy(fxy, tanazel0, fov_deg):
            cosfov = np.cos(fov_deg * np.pi / 180.)
            cos2fov = cosfov * cosfov
            K = 2. * tanazel0
            C = np.roots([(cos2fov - 1),
                          2. * K * (cos2fov - 1),
                          cos2fov * K * K + 2. * cos2fov - K * K + 2,
                          2. * K * (cos2fov + 1),
                          cos2fov * (K * K + 1.) - 1])
            C = np.real(C)
            C = C[cosfov * (1 - K * C - C * C) >= -1e-9]
            C = C[(tanazel0 * fxy + C * fxy) * 2. + 1 > 0]
            if len(C) == 0:
                raise Exception("Couldn't compute the rectified pinhole "
                                "center pixel")
            return C[np.argmax(cosfov * (1 - K * C - C * C))] * fxy

        tanaz0 = np.tan(az0)
        tanel0 = np.tan(el0)
        fxycxy[2] = cxy(fxycxy[0], tanaz0, az_fov_deg)
        fxycxy[3] = cxy(fxycxy[1], tanel0, el_fov_deg)
        Naz = round((tanaz0 * fxycxy[0] + fxycxy[2]) * 2.) + 1
        Nel = round((tanel0 * fxycxy[1] + fxycxy[3]) * 2.) + 1
    if Nel <= 0:
        raise Exception(f"Nonsensical rectified geometry: Nel={Nel}")

    Rt_rect0_cam0 = np.concatenate([R_rect0_cam0, np.zeros((1, 3))], axis=0)
    Rt_rect0_ref = _host(_pose.compose_Rt, Rt_rect0_cam0,
                         models[0].Rt_cam_ref())
    R_rect1_cam1 = R_rect0_cam0 @ Rt01[:3, :]
    Rt_rect1_cam1 = np.concatenate([R_rect1_cam1, np.zeros((1, 3))], axis=0)
    Rt_rect1_ref = _host(_pose.compose_Rt, Rt_rect1_cam1,
                         models[1].Rt_cam_ref())

    models_rectified = tuple(
        cameramodel(intrinsics=(rectification_model, fxycxy),
                    imagersize=(int(Naz), int(Nel)),
                    rt_cam_ref=_host(_pose.rt_from_Rt, Rt))
        for Rt in (Rt_rect0_ref, Rt_rect1_ref))
    if not return_metadata:
        return models_rectified
    metadata = dict(az_fov_deg=az_fov_deg, el_fov_deg=el_fov_deg,
                    az0_deg=az0 * 180. / np.pi, el0_deg=el0_deg,
                    pixels_per_deg_az=pixels_per_deg_az,
                    pixels_per_deg_el=pixels_per_deg_el,
                    baseline=baseline)
    return models_rectified, metadata


def _validate_rectification(models_rectified):
    lm = models_rectified[0].intrinsics()[0]
    if lm not in ('LENSMODEL_LATLON', 'LENSMODEL_PINHOLE'):
        raise Exception("rectified models must be LATLON or PINHOLE")
    i0 = models_rectified[0].intrinsics()[1]
    i1 = models_rectified[1].intrinsics()[1]
    if not np.allclose(i0, i1):
        raise Exception("rectified models must share intrinsics")
    return lm


def rectification_maps(models, models_rectified, *, device=None):
    """Pixel maps for remapping raw images to the rectified space
    (reference: stereo.py:821 / stereo.c:824).  Returns numpy float32
    (2, Nel, Naz, 2): for each camera, the raw pixel of each rectified
    pixel."""
    _validate_rectification(models_rectified)
    device = resolve_device(device)
    Naz, Nel = models_rectified[0].imagersize()
    v_rect = _unproject(_pixel_grid(int(Naz), int(Nel), device),
                        *_intrinsics(models_rectified[0], device),
                        False, False)
    maps = []
    for i in range(2):
        R_cam_rect = torch.as_tensor(_host(
            _pose.compose_Rt, models[i].Rt_cam_ref(),
            models_rectified[i].Rt_ref_cam())[:3, :], device=device)
        v_cam = torch.einsum("ij,...j->...i", R_cam_rect, v_rect)
        maps.append(_project(v_cam, *_intrinsics(models[i], device),
                             False).to(torch.float32))
    return torch.stack(maps).cpu().numpy()


def _as_device(a, device):
    if torch.is_tensor(a):
        return a.to(device)
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def stereo_range(disparity, models_rectified, *,
                 disparity_scale=1, disparity_min=None,
                 disparity_scaled_min=None,
                 disparity_max=None, disparity_scaled_max=None,
                 qrect0=None, device=None):
    """Convert disparity (pixels, possibly scaled) to ranges (reference:
    stereo.py:978 / stereo.c:1263-1417): a float64 tensor on the device,
    0 where the disparity is invalid.

    For LENSMODEL_LATLON: range = baseline cos(az1) / sin(az0 - az1)."""
    lm = _validate_rectification(models_rectified)
    device = resolve_device(device)
    fx, fy, cx, cy = models_rectified[0].intrinsics()[1][:4]
    Rt01 = _host(_pose.compose_Rt, models_rectified[0].Rt_cam_ref(),
                 models_rectified[1].Rt_ref_cam())
    baseline = np.linalg.norm(Rt01[3, :])

    disparity = _as_device(disparity, device)
    # an integer disparity is divided in float64, a float one in its dtype
    # (as the JAX package's weakly typed scale); the divisors are device
    # scalars: torch on CUDA multiplies by the reciprocal of a host scalar
    d = (disparity if disparity.is_floating_point()
         else disparity.to(torch.float64))
    d = d / d.new_full((), float(disparity_scale))
    if qrect0 is None:
        qx = torch.arange(disparity.shape[-1], dtype=d.dtype, device=device)
        qx = torch.broadcast_to(qx, disparity.shape)
    else:
        qx = _as_device(qrect0, device)[..., 0]

    valid = d > 0
    if disparity_min is not None:
        valid = valid & (d >= disparity_min)
    if disparity_scaled_min is not None:
        valid = valid & (disparity >= disparity_scaled_min)
    if disparity_max is not None:
        valid = valid & (d <= disparity_max)
    if disparity_scaled_max is not None:
        valid = valid & (disparity <= disparity_scaled_max)

    # fx, cx and the baseline are float64: the formulas run in float64
    d = d.to(torch.float64)
    qx = qx.to(torch.float64)
    fx = d.new_full((), fx)
    t0 = (qx - cx) / fx
    t1 = t0 - d / fx
    if lm == 'LENSMODEL_LATLON':
        az0, az1 = t0, t1
    else:
        az0, az1 = torch.arctan(t0), torch.arctan(t1)
    r = baseline * torch.cos(az1) / torch.sin(
        torch.clamp_min(az0 - az1, 1e-12))
    return torch.where(valid, r, 0.0)


def stereo_unproject(disparity, models_rectified, *,
                     ranges=None, disparity_scale=1, qrect0=None,
                     device=None):
    """Unproject rectified pixels + disparity to 3D points in the rect0
    frame (reference: stereo.py:1453): a float64 tensor (..., 3) on the
    device."""
    device = resolve_device(device)
    if ranges is None:
        ranges = stereo_range(disparity, models_rectified,
                              disparity_scale=disparity_scale, qrect0=qrect0,
                              device=device)
    ranges = _as_device(ranges, device)
    if qrect0 is None:
        H, W = ranges.shape[-2:]
        qrect0 = _pixel_grid(W, H, device)
    else:
        qrect0 = _as_device(qrect0, device).to(torch.float64)
    v = _unproject(qrect0, *_intrinsics(models_rectified[0], device),
                   True, False)
    return v * ranges[..., None]


def match_feature(image0, image1, q0, *,
                  search_radius1=20,
                  template_size1=17,
                  q1_estimate=None,
                  H10=None,
                  method=None,
                  visualize=False,
                  device=None,
                  **kwargs):
    """Find the position in image1 of the feature at q0 in image0
    (reference: stereo.py:1609).  Normalized cross-correlation over a
    search window, every offset scored in one batched gather, with
    subpixel refinement by quadratic fit.

    Returns (q1, diagnostics_dict); q1 is None if the match failed."""
    device = resolve_device(device)
    image0 = _as_device(image0, device).to(torch.float64)
    image1 = _as_device(image1, device).to(torch.float64)
    q0 = np.asarray(q0, dtype=np.float64)
    if q1_estimate is None:
        if H10 is not None:
            H10 = np.asarray(H10)
            qh = H10 @ np.array([q0[0], q0[1], 1.0])
            q1_estimate = qh[:2] / qh[2]
        else:
            q1_estimate = q0
    q1_estimate = np.asarray(q1_estimate, dtype=np.float64)

    t = template_size1 // 2
    dy, dx = (torch.as_tensor(a, dtype=torch.float64, device=device)
              for a in np.mgrid[-t:t + 1, -t:t + 1])

    templ = _map_coordinates(image0, q0[1] + dy, q0[0] + dx, "nearest")
    templ = templ - torch.mean(templ)
    tnorm = torch.sqrt(torch.sum(templ * templ))

    r = search_radius1
    # (N,2) (dy,dx)
    offs = torch.as_tensor(np.mgrid[-r:r + 1, -r:r + 1].reshape(2, -1).T,
                           dtype=torch.float64, device=device)
    centers = torch.as_tensor(q1_estimate, device=device) + offs.flip(-1)
    patch = _map_coordinates(image1, centers[:, 1, None, None] + dy,
                             centers[:, 0, None, None] + dx, "nearest")
    patch = patch - torch.mean(patch, dim=(-2, -1), keepdim=True)
    pnorm = torch.sqrt(torch.sum(patch * patch, dim=(-2, -1)))
    scores = torch.sum(patch * templ, dim=(-2, -1)) / (pnorm * tnorm + 1e-12)
    scores2d = scores.cpu().numpy().reshape(2 * r + 1, 2 * r + 1)
    iy, ix = np.unravel_index(np.argmax(scores2d), scores2d.shape)
    if iy in (0, 2 * r) or ix in (0, 2 * r):
        return None, dict(matchoutput_image=scores2d)

    # subpixel: quadratic fit around the peak
    def subpix(sm1, s0, sp1):
        denom = sm1 - 2 * s0 + sp1
        return 0.0 if abs(denom) < 1e-12 else 0.5 * (sm1 - sp1) / denom
    ddx = subpix(scores2d[iy, ix - 1], scores2d[iy, ix],
                 scores2d[iy, ix + 1])
    ddy = subpix(scores2d[iy - 1, ix], scores2d[iy, ix],
                 scores2d[iy + 1, ix])
    q1 = q1_estimate + np.array([ix - r + ddx, iy - r + ddy])
    return q1, dict(matchoutput_image=scores2d,
                    score=float(scores2d[iy, ix]))


def _boxsum(x, b):
    """The zero-padded (2b+1) x (2b+1) box sum over the last two axes of x
    (convolve2d(x, ones, mode="same")), as shifted sums along each axis:
    exact, in any order, on integer values whose sums stay below 2^24."""
    H, W = x.shape[-2:]
    p = torch.nn.functional.pad(x, (b, b, b, b))
    rows = p[..., :, 0:W].clone()
    for k in range(1, 2 * b + 1):
        rows += p[..., :, k:k + W]
    out = rows[..., 0:H, :].clone()
    for k in range(1, 2 * b + 1):
        out += rows[..., k:k + H, :]
    return out


def _shifted_columns(im, ds):
    """(len(ds), H, W) stack of im rolled by each d along its columns
    (jnp.roll(im, d, axis=1): columns wrap around)."""
    H, W = im.shape
    x = torch.arange(W, device=im.device)
    idx = torch.remainder(x[None, :] - ds[:, None], W)           # (Nd, W)
    return torch.gather(im.expand(len(ds), H, W), 2,
                        idx[:, None, :].expand(len(ds), H, W))


def _ncc_scores(im0, im1, disparity_min, disparity_max, block_size):
    """The (Nd, H, W) float32 zero-mean NCC scores of the JAX package's
    stereo_matching_ncc, built NCC_CHUNK disparities at a time, and var0."""
    H, W = im0.shape
    b = block_size // 2
    # divisions by a device scalar: torch on CUDA multiplies by the
    # reciprocal of a host scalar divisor
    n = im0.new_full((), float(block_size * block_size))
    mean0 = _boxsum(im0, b) / n
    var0 = _boxsum(im0 * im0, b) / n - mean0 * mean0
    ds = torch.arange(disparity_min, disparity_max + 1, device=im0.device)
    scores = torch.empty((len(ds), H, W), dtype=torch.float32,
                         device=im0.device)
    for k in range(0, len(ds), NCC_CHUNK):
        im1s = _shifted_columns(im1, ds[k:k + NCC_CHUNK])
        mean1 = _boxsum(im1s, b) / n
        var1 = _boxsum(im1s * im1s, b) / n - mean1 * mean1
        cov = _boxsum(im0 * im1s, b) / n - mean0 * mean1
        # the float32 square root through float64 is correctly rounded on
        # every device (torch's float32 sqrt on CUDA is not)
        scores[k:k + NCC_CHUNK] = cov / torch.sqrt(
            torch.clamp_min(var0 * var1, 1e-6).to(torch.float64)).to(
                torch.float32)
    return scores, var0


def stereo_matching_ncc(rectified0, rectified1, *,
                        disparity_min=0, disparity_max=64,
                        block_size=9, device=None):
    """Dense stereo block matching: zero-mean NCC over a sliding window,
    the best disparity of each pixel and its parabola refinement (the
    libelas/SGBM-equivalent slot, reference:
    stereo-matching-libelas.cc).  Column shifts wrap around the image, as
    the JAX package's jnp.roll.

    Returns float32 numpy disparity (H,W); invalid pixels get 0."""
    device = resolve_device(device)
    im0 = _as_device(rectified0, device).to(torch.float32)
    im1 = _as_device(rectified1, device).to(torch.float32)
    scores, var0 = _ncc_scores(im0, im1, disparity_min, disparity_max,
                               block_size)
    smax, best = torch.max(scores, dim=0)
    disp = (best + disparity_min).to(torch.float32)
    # subpixel parabola fit
    i = torch.clamp(best, 1, scores.shape[0] - 2)[None]
    sm1 = torch.gather(scores, 0, i - 1)[0]
    s0 = torch.gather(scores, 0, i)[0]
    sp1 = torch.gather(scores, 0, i + 1)[0]
    denom = sm1 - 2 * s0 + sp1
    sub = torch.where(torch.abs(denom) > 1e-9, 0.5 * (sm1 - sp1) / denom,
                      0.0)
    disp = disp + torch.where(best == i[0], sub, 0.0)
    # texture/score validity
    valid = (smax > 0.3) & (var0 > 1.0)
    return torch.where(valid, disp, 0.0).cpu().numpy()
