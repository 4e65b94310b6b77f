"""Image I/O, colormaps and contrast equalization.

Counterpart of ``mrcal_tpu/image.py``.  Loading and saving are host work
through PIL, imported only when an image file is read or written (so
nothing else of the port needs PIL); ``apply_color_map`` is a torch op on
the entry point's device; the two equalizations are host numpy, with
OpenCV's CLAHE when ``cv2`` is importable, as in the JAX package.
"""

import numpy as np
import torch

from ._config import resolve_device


def load_image(filename, *, bits_per_pixel=None, channels=None):
    """Load an image into a numpy array (reference: mrcal.load_image).

    bits_per_pixel/channels request a specific output format:
    (8,1) uint8 gray, (16,1) uint16 gray, (24,3) uint8 bgr."""
    from PIL import Image
    im = Image.open(filename)
    arr = np.asarray(im)

    if channels == 1 or (channels is None and arr.ndim == 2):
        if arr.ndim == 3:
            # rgb -> gray (ITU-R 601 luma, matching stb's conversion)
            arr = (0.299 * arr[..., 0] + 0.587 * arr[..., 1]
                   + 0.114 * arr[..., 2])
        if bits_per_pixel == 16:
            if arr.dtype != np.uint16:
                arr = (arr.astype(np.float64)
                       * (65535.0 / 255.0)).round().astype(np.uint16) \
                    if arr.dtype == np.uint8 else arr.astype(np.uint16)
        else:
            if arr.dtype == np.uint16:
                arr = (arr >> 8).astype(np.uint8)
            elif arr.dtype != np.uint8:
                arr = np.clip(arr, 0, 255).astype(np.uint8)
        return np.ascontiguousarray(arr)

    # color: return BGR like the reference (mrcal_image_bgr_t)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if arr.shape[-1] == 4:
        arr = arr[..., :3]
    return np.ascontiguousarray(arr[..., ::-1])


def save_image(filename, array):
    """Save an image (uint8 gray / uint16 gray / uint8 bgr)."""
    from PIL import Image
    if torch.is_tensor(array):
        array = array.cpu().numpy()
    array = np.asarray(array)
    # uint16 gray becomes PIL's mode I;16
    im = Image.fromarray(array[..., ::-1] if array.ndim == 3   # bgr -> rgb
                         else array)
    im.save(filename)


def apply_color_map(image, *, a_min=None, a_max=None,
                    function_red=None, function_green=None,
                    function_blue=None, device=None):
    """Colormap a scalar image to BGR (reference: mrcal_apply_color_map,
    mrcal.h:892-929): the reference's jet-like map, in float64, as a uint8
    tensor (..., 3) on `device` (the card unless given "cpu").  a_min and
    a_max default to the image's extremes, NaN ignored."""
    device = resolve_device(device)
    image = torch.as_tensor(np.asarray(image, dtype=np.float64)
                            if not torch.is_tensor(image) else image,
                            dtype=torch.float64, device=device)
    if a_min is None or a_max is None:
        seen = image[~torch.isnan(image)]
        if a_min is None:
            a_min = float(seen.min())
        if a_max is None:
            a_max = float(seen.max())
    # a divisor on the device: torch on CUDA multiplies by the reciprocal
    # of a host scalar, where numpy divides
    span = image.new_full((), max(a_max - a_min, 1e-30))
    x = torch.clamp((image - a_min) / span, 0.0, 1.0)
    # jet-style piecewise map
    r = torch.clamp(1.5 - torch.abs(4 * x - 3), 0, 1)
    g = torch.clamp(1.5 - torch.abs(4 * x - 2), 0, 1)
    b = torch.clamp(1.5 - torch.abs(4 * x - 1), 0, 1)
    out = torch.stack([b, g, r], dim=-1)   # BGR
    return (out * 255).to(torch.uint8)


def clahe_equalize(image, tiles=8, clip=2.0):
    """Contrast-limited adaptive histogram equalization -> uint8.

    Reference: mrcal-stereo --clahe / --equalization clahe (which calls
    cv2.createCLAHE).  cv2 is used when available; otherwise a numpy
    tile-interpolated implementation (per-tile clipped CDFs, bilinear
    blend) with equivalent behavior."""
    image = np.asarray(image)
    try:
        import cv2
        c = cv2.createCLAHE(clipLimit=clip, tileGridSize=(tiles, tiles))
        return c.apply(image.astype(np.uint8))
    except ImportError:
        pass
    im = image.astype(np.float64)
    im = (im - im.min()) / max(im.max() - im.min(), 1e-9)
    H, W = im.shape
    th, tw = (H + tiles - 1) // tiles, (W + tiles - 1) // tiles
    nbins = 256
    q = np.clip((im * (nbins - 1)).astype(int), 0, nbins - 1)
    # per-tile clipped CDFs
    cdfs = np.zeros((tiles, tiles, nbins))
    for ty in range(tiles):
        for tx in range(tiles):
            tile = q[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw]
            h = np.bincount(tile.ravel(), minlength=nbins).astype(float)
            limit = clip * h.mean()
            excess = np.maximum(h - limit, 0).sum()
            h = np.minimum(h, limit) + excess / nbins
            c = np.cumsum(h)
            cdfs[ty, tx] = c / max(c[-1], 1e-9)
    # bilinear interpolation between tile CDFs
    ty = np.clip((np.arange(H) - th / 2) / th, 0, tiles - 1 - 1e-9)
    tx = np.clip((np.arange(W) - tw / 2) / tw, 0, tiles - 1 - 1e-9)
    ty0 = ty.astype(int)
    tx0 = tx.astype(int)
    fy = (ty - ty0)[:, None]
    fx = (tx - tx0)[None, :]
    ty1 = np.minimum(ty0 + 1, tiles - 1)
    tx1 = np.minimum(tx0 + 1, tiles - 1)
    v00 = cdfs[ty0[:, None], tx0[None, :], q]
    v01 = cdfs[ty0[:, None], tx1[None, :], q]
    v10 = cdfs[ty1[:, None], tx0[None, :], q]
    v11 = cdfs[ty1[:, None], tx1[None, :], q]
    out = (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx +
           v10 * fy * (1 - fx) + v11 * fy * fx)
    return (out * 255).astype(np.uint8)


def stretch_equalize(image):
    """Global min/max contrast stretch -> uint8 (mrcal-stereo
    --equalization stretch)."""
    im = np.asarray(image).astype(np.float64)
    lo, hi = im.min(), im.max()
    return (255.0 * (im - lo) / max(hi - lo, 1e-9)).astype(np.uint8)
