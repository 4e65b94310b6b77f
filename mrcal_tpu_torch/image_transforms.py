"""Image reprojection between lens models.

Counterpart of ``mrcal_tpu/image_transforms.py``.  The pinhole fits are
host numpy on the port's unprojection; ``image_transformation_map``
unprojects the destination grid in float64 on the entry point's device
and projects it into the source model; ``transform_image`` is the
bilinear remap, one four-corner gather for every channel at once, with
the semantics of ``jax.scipy.ndimage.map_coordinates(order=1,
mode="constant", cval=0)``: each corner outside the image contributes 0
on its own, and integer images are rounded half away from zero.  The
maps and the images come back as numpy, as in the JAX package.
"""

import numpy as np
import torch

from ._config import resolve_device
from .model_analysis import _intrinsics, is_within_valid_intrinsics_region
from .poseutils import (_as_tensors, _compose_Rt2, _invert_Rt,
                        _rotate_point_R, _transform_point_Rt)
from .projections import _project, _unproject


def _pixel_grid(W, H, device):
    """The pixel coordinates (H, W, 2) of a W x H imager, float64."""
    qy, qx = torch.meshgrid(
        torch.arange(H, dtype=torch.float64, device=device),
        torch.arange(W, dtype=torch.float64, device=device), indexing="ij")
    return torch.stack([qx, qy], dim=-1)


def scale_focal__best_pinhole_fit(model, fit, *, device=None):
    """The focal-length scale fitting the requested view into a pinhole
    reprojection (reference: image_transforms.py:24).

    fit: None, 'corners', 'centers-horizontal', 'centers-vertical', or an
    (N,2) array of pixel points to fit."""
    if fit is None:
        return 1.0
    W, H = model.imagersize()
    if isinstance(fit, str):
        if fit == "corners":
            q = np.array(((0., 0.), (0., H - 1.),
                          (W - 1., 0.), (W - 1., H - 1.)))
        elif fit == "centers-horizontal":
            q = np.array(((0., (H - 1.) / 2.), (W - 1., (H - 1.) / 2.)))
        elif fit == "centers-vertical":
            q = np.array((((W - 1.) / 2., 0.), ((W - 1.) / 2., H - 1.)))
        else:
            raise Exception(f"Unknown fit='{fit}'")
    else:
        q = np.asarray(fit)

    device = resolve_device(device)
    intr, lm = _intrinsics(model, device)
    v = _unproject(torch.as_tensor(q, dtype=torch.float64, device=device),
                   intr, lm, False, False).cpu().numpy()
    fx, fy, cx, cy = model.intrinsics()[1][:4]
    # normalized pinhole coords of the fit points; x*f*scale + cx in
    # [0, W-1] for all points -> a scale bound per point
    xy = v[..., :2] / v[..., 2:3]
    scales = []
    for (x, y) in xy:
        if x < 0:
            scales.append((0 - cx) / (x * fx))
        else:
            scales.append((W - 1 - cx) / (x * fx))
        if y < 0:
            scales.append((0 - cy) / (y * fy))
        else:
            scales.append((H - 1 - cy) / (y * fy))
    scales = [s for s in scales if s > 0]
    return float(min(scales)) if scales else 1.0


def pinhole_model_for_reprojection(model_from, fit=None, *,
                                   scale_focal=None, scale_image=None,
                                   device=None):
    """A pinhole model for reprojecting images from model_from
    (reference: image_transforms.py:150)."""
    from .cameramodel import cameramodel
    intrinsics_data = model_from.intrinsics()[1]
    if scale_focal is None:
        scale_focal = scale_focal__best_pinhole_fit(model_from, fit,
                                                    device=device)
    fx, fy, cx, cy = intrinsics_data[:4]
    intrinsics_pinhole = np.array([fx * scale_focal, fy * scale_focal,
                                   cx, cy])
    imagersize = np.array(model_from.imagersize())
    if scale_image is not None:
        imagersize = (imagersize.astype(float) * scale_image + 0.5).astype(int)
        intrinsics_pinhole *= scale_image
    return cameramodel(
        intrinsics=("LENSMODEL_PINHOLE", intrinsics_pinhole),
        imagersize=imagersize,
        rt_cam_ref=model_from.extrinsics_rt_fromref())


def image_transformation_map(model_from, model_to, *,
                             intrinsics_only=False,
                             distance=None,
                             plane_n=None, plane_d=None,
                             mask_valid_intrinsics_region_from=False,
                             device=None):
    """The pixel map transforming images captured by model_from into the
    view of model_to (reference: image_transforms.py:276).  Returns
    (H, W, 2) float32 numpy of source pixel coords per destination pixel;
    with mask_valid_intrinsics_region_from, -1 where they leave
    model_from's valid-intrinsics region."""
    device = resolve_device(device)
    W, H = model_to.imagersize()
    v_to = _unproject(_pixel_grid(int(W), int(H), device),
                      *_intrinsics(model_to, device),
                      distance is not None, False)

    if not intrinsics_only:
        Rt_to_ref, Rt_ref_from = _as_tensors(device, model_to.Rt_cam_ref(),
                                             model_from.Rt_ref_cam())
        Rt_from_to = _invert_Rt(_compose_Rt2(Rt_to_ref, Rt_ref_from))
        if plane_n is not None:
            # points on a plane n.p = d in the 'to' camera coords
            n = torch.as_tensor(np.asarray(plane_n), dtype=v_to.dtype,
                                device=device)
            k = plane_d / torch.einsum("...i,i->...", v_to, n)
            v_from = _transform_point_Rt(Rt_from_to, v_to * k[..., None])
        elif distance is not None:
            v_from = _transform_point_Rt(Rt_from_to, v_to * distance)
        else:
            v_from = _rotate_point_R(Rt_from_to[:3, :], v_to)
    else:
        v_from = v_to

    q_from = _project(v_from, *_intrinsics(model_from, device), False)
    out = q_from.to(torch.float32)
    if mask_valid_intrinsics_region_from:
        # the region test in float64 on the float32 map, as matplotlib's
        mask = is_within_valid_intrinsics_region(out.to(torch.float64),
                                                 model_from, device=device)
        if mask is not None:
            out[~mask] = -1.0
    return out.cpu().numpy()


def _round_half_away_from_zero(x):
    t = torch.trunc(x)
    # x - trunc(x) is exact
    return torch.where((x - t).abs() >= 0.5, t + torch.sign(x), t)


def _map_coordinates(image, rows, cols, mode):
    """jax.scipy.ndimage.map_coordinates(order=1) of image (H, W[, C]) at
    (rows, cols), every channel at once: the weights in the coordinates'
    dtype, lower = floor(c), w_hi = c - lower, w_lo = 1 - w_hi; with mode
    "constant" a corner outside the image contributes 0 (cval), with
    "nearest" its index is clamped to the image; the terms summed in the
    order (r0,c0), (r0,c1), (r1,c0), (r1,c1), in the promoted dtype of the
    weights and the image; rounded half away from zero for an integer
    image (the caller casts)."""
    H, W = image.shape[:2]
    chan = (1,) * (image.ndim - 2)
    dtype = torch.promote_types(image.dtype, rows.dtype)
    flat = image.reshape((H * W,) + image.shape[2:]).to(dtype)
    nodes = []
    for c in (rows, cols):
        lower = torch.floor(c)
        w_hi = c - lower
        i = lower.to(torch.int64)
        nodes.append(((i, 1 - w_hi), (i + 1, w_hi)))
    out = None
    for ir, wr in nodes[0]:
        for ic, wc in nodes[1]:
            if mode == "nearest":
                v = flat[ir.clamp(0, H - 1) * W + ic.clamp(0, W - 1)]
            else:
                valid = (ir >= 0) & (ir < H) & (ic >= 0) & (ic < W)
                v = torch.where(valid.reshape(valid.shape + chan),
                                flat[torch.where(valid, ir * W + ic, 0)],
                                torch.zeros((), dtype=dtype,
                                            device=flat.device))
            w = wr * wc
            term = w.reshape(w.shape + chan) * v
            out = term if out is None else out + term
    if not image.is_floating_point():
        out = _round_half_away_from_zero(out)
    return out


def transform_image(image, mapxy, *, out=None, interpolation=None,
                    device=None):
    """Remap an image through a pixel map (reference:
    image_transforms.py:514, a cv2.remap wrapper; here bilinear, as the
    JAX package's map_coordinates).  image: (H, W) or (H, W, C); mapxy
    (H', W', 2) source (x, y) per output pixel.  Returns numpy of the
    image's dtype (or fills out)."""
    device = resolve_device(device)
    if torch.is_tensor(image):
        dtype = torch.empty(0, dtype=image.dtype).numpy().dtype
        image = image.to(device)
    else:
        image = np.asarray(image)
        dtype = image.dtype
        if dtype.kind == "u" and dtype != np.uint8:
            image = image.astype(np.int64)     # torch's own uint16/32 are thin
        image = torch.as_tensor(np.ascontiguousarray(image), device=device)
    mapxy = (mapxy.to(device) if torch.is_tensor(mapxy) else
             torch.as_tensor(np.ascontiguousarray(mapxy), device=device))
    res = _map_coordinates(image, mapxy[..., 1], mapxy[..., 0],
                           "constant").cpu().numpy()
    if dtype == np.uint8:
        res = np.clip(res, 0, 255)
    elif dtype == np.uint16:
        res = np.clip(res, 0, 65535)
    res = res.astype(dtype)
    if out is not None:
        np.copyto(out, res)
        return out
    return res
