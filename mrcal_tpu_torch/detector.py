"""Chessboard corner detection.

Counterpart of ``mrcal_tpu/detector.py`` (the mrgingham-equivalent
detector), with its device work on the entry point's device:

- ``chess_response``: the ChESS-style ring operator (16 samples on a
  radius-5 ring, edge-padded), float32, as shifted-image arithmetic in
  the JAX package's order of operations, so that on 8-bit images it is
  exact and equal to the JAX package's bit for bit (exact ties decide
  which plateau maxima survive).
- non-maximum suppression: a max filter (``max_pool2d``, -inf padding),
  then the JAX package's greedy grouping of exact-tie plateaus on the host
  over the candidates.
- ``_refine_subpixel``: the quadratic fit of all candidates at once (the
  3x3 neighbourhoods gathered on the device, the float32 2x2 solves on the
  host with numpy's, as the JAX package makes them).
- ``_refine_saddle``: the gradient-orthogonality refinement of all corners
  at once on the device, each corner carrying a "still iterating" flag
  that reproduces each exit of the JAX package's per-corner loop.
- ``_order_into_grid``: host numpy with scipy's cKDTree, as it is there.
  Its order of a square grid may be the board's mirror image (rows along
  the image's y: the JAX package returns about a third of square boards
  so, which a calibration cannot use); find_chessboard_corners transposes
  those last (``_unmirror``), so that rows run along the image's x.

The decimation pyramid averages 2**level x 2**level blocks on the device;
on integer-valued images (8- and 16-bit) the block sums are exact in
float32, so the order of the sum does not matter there.  On float images
the device may sum in another order than numpy, and levels >= 1 may then
differ from the JAX package's in the last bit.
"""

import time

import numpy as np
import torch

from ._config import resolve_device


# 16 ring offsets of radius ~5 (dx, dy), in angular order; ChESS sampling
# geometry.
_RING = [(5, 0), (5, 2), (4, 4), (2, 5),
         (0, 5), (-2, 5), (-4, 4), (-5, 2),
         (-5, 0), (-5, -2), (-4, -4), (-2, -5),
         (0, -5), (2, -5), (4, -4), (5, -2)]


def _shift(im, dx, dy):
    """Image (..., H, W) shifted so that out[y,x] = im[y+dy, x+dx],
    edge-padded."""
    H, W = im.shape[-2:]
    iy = (torch.arange(H, device=im.device) + dy).clamp_(0, H - 1)
    ix = (torch.arange(W, device=im.device) + dx).clamp_(0, W - 1)
    return im.index_select(-2, iy).index_select(-1, ix)


def _chess_response(im):
    """chess_response of a float32 tensor (..., H, W), where it lies.  The
    sums run left to right from n = 0, as the JAX package's."""
    s = [_shift(im, dx, dy) for dx, dy in _RING]
    SR = torch.abs(s[0] - s[4])
    DR = torch.abs(s[0] - s[8])
    ringsum = s[0]
    for n in range(1, 16):
        SR = SR + torch.abs(s[n] - s[(n + 4) % 16])
        DR = DR + torch.abs(s[n] - s[(n + 8) % 16])
        ringsum = ringsum + s[n]
    # local mean over a small neighborhood (center + 4 half-radius taps):
    # a true division, as XLA keeps it (on CUDA, torch multiplies by the
    # reciprocal of a host scalar divisor; a divisor on the device is
    # divided by)
    local = (im
             + _shift(im, 2, 0) + _shift(im, -2, 0)
             + _shift(im, 0, 2) + _shift(im, 0, -2)) / im.new_full((), 5.0)
    MR = torch.abs(ringsum - 16.0 * local)
    return torch.clamp_min(SR - DR - MR, 0.0)


def _image_tensor(image, device):
    """A grayscale image as float32 on `device` (color: the mean of the
    channels, computed as the JAX package computes it)."""
    if torch.is_tensor(image):
        im = image.to(device=device, dtype=torch.float32)
        return im.mean(dim=-1) if im.dim() == 3 else im
    im = np.asarray(image)
    if im.ndim == 3:
        im = np.asarray(im, dtype=np.float32).mean(axis=-1)
    # integer images travel as they are, and convert exactly there
    return _as_tensor(im, device).to(torch.float32)


def _as_tensor(a, device):
    """A numpy array as a tensor on `device` (a copy where torch cannot
    take its memory)."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.as_tensor(a, device=device)


def chess_response(image, *, device=None):
    """Per-pixel chessboard-vertex response map (float32, same shape; a
    stack (..., H, W) of images too).

    ChESS-style combination of 16 ring samples s_n:
      SR  = sum_n |s_n - s_{n+4}|      (quarter-turn flips: large at vertex)
      DR  = sum_n |s_n - s_{n+8}|      (half-turn symmetry: small at vertex)
      MR  = |sum_n s_n - 16 * local_mean|   (rejects lines/blobs)
      R   = max(0, SR - DR - MR)
    Runs on the card unless device says otherwise."""
    device = resolve_device(device)
    if torch.is_tensor(image):
        im = image.to(device=device, dtype=torch.float32)
    else:
        im = _as_tensor(image, device).to(torch.float32)
    return _chess_response(im)


def _local_maxima(response, threshold, nms_radius=4):
    """Coordinates (N,2) of local maxima above threshold and their
    responses, host numpy.  response: float32 tensor (H, W); threshold: a
    numpy scalar, compared in the dtype numpy gives it (as the JAX package
    compares it)."""
    k = 2 * nms_radius + 1
    mx = torch.nn.functional.max_pool2d(response[None, None], k, stride=1,
                                        padding=nms_radius)[0, 0]
    thr = np.asarray(threshold)
    r_cmp = response.double() if thr.dtype == np.float64 else response
    keep = (response == mx) & (r_cmp > torch.as_tensor(
        thr, dtype=r_cmp.dtype, device=response.device))
    yx = torch.nonzero(keep)                     # row-major, as np.nonzero
    resp = response[yx[:, 0], yx[:, 1]].cpu().numpy()
    yx = yx.cpu().numpy()
    xy = yx[:, ::-1].astype(np.int64)
    # the max filter keeps ALL pixels of an exact-tie plateau (common on
    # clean synthetic imagery); greedily suppress any maximum within
    # nms_radius of an equal-or-stronger one: each candidate, strongest
    # first, joins the first kept maximum within reach, or is kept
    order = np.argsort(-resp, kind="stable")
    taken = []        # indices of kept maxima
    taken_xy = np.zeros((len(order), 2), np.int64)
    groups = []       # exact-tie plateau members per kept maximum
    for i in order:
        near = np.flatnonzero(np.max(np.abs(
            taken_xy[:len(taken)] - xy[i]), axis=1) <= nms_radius)
        if not len(near):
            taken_xy[len(taken)] = xy[i]
            taken.append(i)
            groups.append([i])
        elif resp[i] == resp[taken[near[0]]]:
            groups[near[0]].append(i)
    taken = np.array(taken, dtype=np.int64)
    # exact-tie plateaus (flat peaks of the piecewise-linear response on
    # clean imagery): the centroid of the tie group is the true center
    cxy = np.stack([xy[g].mean(axis=0) for g in groups], axis=0)
    return cxy, resp[taken]


def _refine_subpixel(response, xy):
    """Quadratic-fit subpixel refinement on the response surface, of all
    candidates xy (N, 2) at once.

    xy may be fractional (plateau centroids); the fit runs at the nearest
    integer pixel and keeps the input position when the pixel is on the
    border or the local quadratic is degenerate (|det| < 1e-12: a flat
    plateau, where the centroid is already the best estimate) or its step
    leaves the pixel's neighbourhood (|d| > 1).  The response's 3x3
    neighbourhoods are gathered where it lies; the fit is the JAX
    package's float32 arithmetic and numpy solve, on the host."""
    H, W = response.shape
    out = np.asarray(xy, dtype=np.float64).copy()
    if not len(out):
        return out
    x = np.rint(out[:, 0]).astype(np.int64)
    y = np.rint(out[:, 1]).astype(np.int64)
    inside = (1 <= x) & (x < W - 1) & (1 <= y) & (y < H - 1)
    xc = np.clip(x, 1, W - 2)
    yc = np.clip(y, 1, H - 2)
    d = np.arange(-1, 2)
    iy = torch.as_tensor(yc[:, None, None] + d[None, :, None],
                         device=response.device)
    ix = torch.as_tensor(xc[:, None, None] + d[None, None, :],
                         device=response.device)
    n = response[iy, ix].cpu().numpy()           # (N, 3, 3) float32, [dy, dx]
    dx = np.float32(0.5) * (n[:, 1, 0] - n[:, 1, 2])
    dy = np.float32(0.5) * (n[:, 0, 1] - n[:, 2, 1])
    dxx = n[:, 1, 0] - np.float32(2) * n[:, 1, 1] + n[:, 1, 2]
    dyy = n[:, 0, 1] - np.float32(2) * n[:, 1, 1] + n[:, 2, 1]
    dxy = np.float32(0.25) * (n[:, 2, 2] - n[:, 2, 0]
                              - n[:, 0, 2] + n[:, 0, 0])
    det = dxx * dyy - dxy * dxy
    fit = inside & ~(np.abs(det) < 1e-12)
    if not np.any(fit):
        return out
    Hm = np.stack([np.stack([dxx, dxy], axis=-1),
                   np.stack([dxy, dyy], axis=-1)], axis=-2)[fit]
    rhs = -np.stack([-dx, -dy], axis=-1)[fit]
    step = np.linalg.solve(Hm, rhs[..., None])[..., 0]
    ok = np.all(np.abs(step) <= 1.0, axis=-1)
    i = np.flatnonzero(fit)[ok]
    out[i] = np.stack([x[i], y[i]], axis=-1).astype(np.float64) + step[ok]
    return out


def _gradient(im):
    """np.gradient of a float64 image (H, W): (d/dy, d/dx), central
    differences inside and one-sided ones at the edges."""
    def along(f, dim):
        n = f.shape[dim]
        g = torch.empty_like(f)
        g.narrow(dim, 1, n - 2).copy_(
            (f.narrow(dim, 2, n - 2) - f.narrow(dim, 0, n - 2)) / 2.0)
        g.narrow(dim, 0, 1).copy_(f.narrow(dim, 1, 1) - f.narrow(dim, 0, 1))
        g.narrow(dim, n - 1, 1).copy_(f.narrow(dim, n - 1, 1)
                                      - f.narrow(dim, n - 2, 1))
        return g
    return along(im, 0), along(im, 1)


def _refine_saddle(image, xy, halfwin=5, iters=8):
    """Gradient-orthogonality saddle refinement on the IMAGE (the
    cv2.cornerSubPix formulation): at a chessboard vertex every image
    gradient in a neighborhood is perpendicular to the vector from the
    vertex — solve sum_p w(p) (grad I(p) . (p - q)) grad I(p) = 0 for q
    and iterate.

    All corners at once where the image lies (a float32 tensor (H, W)):
    each iteration gathers every corner's (2 halfwin + 1)^2 window of the
    image's gradient, and a corner stops where the JAX package's loop
    breaks: its window leaves the image, the system is degenerate (det <
    1e-12), the new q is not finite or jumps more than halfwin (q is kept),
    or it moved less than 1e-3 (q is taken).  Returns (N, 2) float64 numpy."""
    xy = np.asarray(xy, dtype=np.float64)
    dev = image.device
    im = image.to(torch.float64)
    gy, gx = _gradient(im)
    H, W = im.shape
    offs = np.arange(-halfwin, halfwin + 1)
    ys, xs = np.meshgrid(offs, offs, indexing="ij")
    w = torch.as_tensor(np.exp(-(xs ** 2 + ys ** 2)
                               / (2.0 * (halfwin / 2.0) ** 2)), device=dev)
    xs = torch.as_tensor(xs, dtype=torch.float64, device=dev)
    ys = torch.as_tensor(ys, dtype=torch.float64, device=dev)
    offs = torch.as_tensor(offs, device=dev)

    q = torch.as_tensor(xy, device=dev).reshape(-1, 2)
    going = torch.ones(q.shape[0], dtype=torch.bool, device=dev)
    for _ in range(iters):
        c = torch.round(q).to(torch.int64)       # half to even, as round()
        cx, cy = c[:, 0], c[:, 1]
        going = going & (halfwin + 1 <= cx) & (cx < W - halfwin - 1) \
            & (halfwin + 1 <= cy) & (cy < H - halfwin - 1)
        cxs = cx.clamp(0, W - 1)
        cys = cy.clamp(0, H - 1)
        iy = (cys[:, None] + offs).clamp(0, H - 1)[:, :, None]
        ix = (cxs[:, None] + offs).clamp(0, W - 1)[:, None, :]
        gxw, gyw = gx[iy, ix], gy[iy, ix]
        px = xs + cx[:, None, None]
        py = ys + cy[:, None, None]
        a = torch.sum(w * gxw * gxw, dim=(1, 2))
        b = torch.sum(w * gxw * gyw, dim=(1, 2))
        cc = torch.sum(w * gyw * gyw, dim=(1, 2))
        det = a * cc - b * b
        going = going & ~(det < 1e-12)
        proj = gxw * px + gyw * py
        bx = torch.sum(w * gxw * proj, dim=(1, 2))
        by = torch.sum(w * gyw * proj, dim=(1, 2))
        qn = torch.stack([(cc * bx - b * by) / det,
                          (a * by - b * bx) / det], dim=-1)
        moved = torch.linalg.vector_norm(qn - q, dim=-1)
        going = going & torch.isfinite(qn).all(dim=-1) & ~(moved > halfwin)
        q = torch.where(going[:, None], qn, q)
        going = going & ~(moved < 1e-3)
    return q.cpu().numpy()


def _order_into_grid(points, gridn_w, gridn_h):
    """Organize an unordered corner cloud into a row-major (gridn_h,gridn_w)
    lattice.  Returns (gridn_h*gridn_w, 2) array or None.

    Lattice growth: from a seed point, estimate the two local grid basis
    vectors from nearest neighbors, then BFS outward assigning integer
    lattice coordinates; each point's basis is re-estimated locally so
    perspective/lens distortion is tolerated.  Off-lattice outliers fail
    the residual gate and are never assigned.
    """
    from scipy.spatial import cKDTree
    N = points.shape[0]
    need = gridn_w * gridn_h
    if N < need:
        return None
    tree = cKDTree(points)
    k = min(9, N)
    dists, nbrs = tree.query(points, k=k)

    # median neighbor spacing ~ lattice pitch
    pitch = np.median(dists[:, 1])
    if not np.isfinite(pitch) or pitch <= 0:
        return None

    def local_basis(i):
        """Two shortest non-collinear neighbor displacements at point i."""
        cand = []
        for j, d in zip(nbrs[i, 1:], dists[i, 1:]):
            if d > 2.0 * pitch:
                break
            v = points[j] - points[i]
            ok = True
            for u in cand:
                cosang = abs(np.dot(u, v)) / (np.linalg.norm(u)
                                              * np.linalg.norm(v))
                if cosang > 0.85:            # collinear with an existing axis
                    ok = False
                    break
            if ok:
                cand.append(v)
            if len(cand) == 2:
                return cand
        return None

    # seed: point nearest the cloud centroid (well inside the grid)
    seed = int(np.argmin(np.linalg.norm(points - points.mean(axis=0),
                                        axis=1)))
    basis = local_basis(seed)
    if basis is None:
        return None
    e1, e2 = basis

    coords = {seed: (0, 0)}
    basis_at = {seed: (e1, e2)}
    queue = [seed]
    assigned = np.full(N, -1, dtype=np.int64)
    assigned[seed] = 0
    while queue:
        i = queue.pop(0)
        ci = np.array(coords[i], dtype=np.float64)
        b1, b2 = basis_at[i]
        B = np.stack([b1, b2], axis=1)
        if abs(np.linalg.det(B)) < 1e-9:
            continue
        Binv = np.linalg.inv(B)
        for j, d in zip(nbrs[i, 1:], dists[i, 1:]):
            if d > 1.6 * max(np.linalg.norm(b1), np.linalg.norm(b2)):
                break
            ab = Binv @ (points[j] - points[i])
            ab_int = np.round(ab)
            if np.max(np.abs(ab - ab_int)) > 0.25:
                continue                       # off-lattice: outlier
            if np.sum(np.abs(ab_int)) != 1:
                continue                       # only 4-connected steps
            cj = tuple((ci + ab_int).astype(int))
            if j in coords:
                continue
            if cj in set(coords.values()):
                continue
            coords[j] = cj
            step = points[j] - points[i]
            # re-estimate the local basis at j: inherit, replace the axis
            # we just stepped along with the measured step
            if abs(ab_int[0]) == 1:
                basis_at[j] = (step * ab_int[0], b2)
            else:
                basis_at[j] = (b1, step * ab_int[1])
            queue.append(j)

    if len(coords) < need:
        return None

    ij = np.array([coords[i] for i in coords])
    idx = np.array(list(coords.keys()))
    imin = ij.min(axis=0)
    ij = ij - imin
    ext = ij.max(axis=0) + 1

    # the assigned component may be larger than the target grid if false
    # positives formed lattice extensions; require an exact W x H window
    # fully populated
    candidates = []
    if (ext[0], ext[1]) == (gridn_w, gridn_h):
        candidates.append((0, 1))              # (axis0 -> x, axis1 -> y)
    if (ext[0], ext[1]) == (gridn_h, gridn_w):
        candidates.append((1, 0))
    if not candidates:
        return None
    ax, ay = candidates[0]

    grid = np.full((gridn_h, gridn_w), -1, dtype=np.int64)
    for (a, b), pi in zip(ij, idx):
        col = (a, b)[ax]
        row = (a, b)[ay]
        if 0 <= row < gridn_h and 0 <= col < gridn_w:
            grid[row, col] = pi
    if np.any(grid < 0):
        return None

    g = points[grid]                            # (H, W, 2)

    # canonical orientation: rows should mostly point along +x of the
    # image, and successive rows along +y (deterministic across cameras
    # that share an approximate orientation, like mrgingham)
    return _flip_canonical(g).reshape(-1, 2)


def _flip_canonical(g):
    """The grid g (H, W, 2) flipped so that its rows run along +x of the
    image on average, and its columns along +y."""
    row_dir = g[:, -1] - g[:, 0]
    if row_dir.mean(axis=0)[0] < 0:
        g = g[:, ::-1]
    col_dir = g[-1] - g[0]
    if col_dir.mean(axis=0)[1] < 0:
        g = g[::-1]
    return g


def _unmirror(corners, gridn_w, gridn_h):
    """A square grid's corners (N, 2) in row-major order with the rows
    along the image's x.  The lattice growth of _order_into_grid may
    number a square lattice with its rows along the image's y, and its
    flips keep that: the board's mirror image, which a calibration cannot
    use (the JAX package returns it for about a third of square boards).
    Such a grid is transposed, then flipped to the canonical orientation.
    Other grids pass unchanged."""
    if gridn_w != gridn_h:
        return corners
    g = corners.reshape(gridn_h, gridn_w, 2)
    row_dir = (g[:, -1] - g[:, 0]).mean(axis=0)
    if abs(row_dir[0]) >= abs(row_dir[1]):
        return corners
    return np.ascontiguousarray(
        _flip_canonical(g.transpose(1, 0, 2))).reshape(-1, 2)


class _StageTimes:
    """Wall time of the detector's stages, summed over calls (host clock;
    each stage ends in a read of its result on the host)."""

    STAGES = ("response", "maxima", "grid", "saddle")

    def __init__(self):
        self.s = dict.fromkeys(self.STAGES, 0.0)
        self.t = time.perf_counter()

    def lap(self, stage):
        t = time.perf_counter()
        self.s[stage] += t - self.t
        self.t = t


def _find_chessboard_corners(im0, gridn_w, gridn_h, max_level,
                             response_threshold_rel, times=None):
    """find_chessboard_corners of a float32 image tensor (H, W)."""
    if times is None:
        times = _StageTimes()
    times.t = time.perf_counter()
    for level in range(max_level + 1):
        if level == 0:
            im = im0
        else:
            s = 2 ** level
            Hc = (im0.shape[0] // s) * s
            Wc = (im0.shape[1] // s) * s
            im = im0[:Hc, :Wc].reshape(Hc // s, s, Wc // s, s).mean((1, 3))
        R = _chess_response(im)
        Rmax = np.float32(R.max().item())
        times.lap("response")
        if Rmax <= 0:
            continue
        xy, _resp = _local_maxima(R, response_threshold_rel * Rmax)
        times.lap("maxima")
        if xy.shape[0] < gridn_w * gridn_h:
            continue
        # strongest Nneed*2 candidates only: false positives slow the BFS
        order = np.argsort(-_resp)[: gridn_w * gridn_h * 2]
        xy = xy[order]
        xys = _refine_subpixel(R, xy)
        g = _order_into_grid(xys, gridn_w, gridn_h)
        times.lap("grid")
        if g is not None:
            # final subpixel polish on the FULL-RES image; window: ~40% of
            # the measured grid pitch, capped at 11 px (see the JAX
            # package's find_chessboard_corners)
            q = g * (2 ** level)
            gg = q.reshape(gridn_h, gridn_w, 2)
            pitch = float(np.median(np.linalg.norm(
                np.diff(gg, axis=1), axis=-1)))
            halfwin = int(np.clip(0.4 * pitch, 3, 11))
            corners = _unmirror(_refine_saddle(im0, q, halfwin=halfwin),
                                gridn_w, gridn_h)
            times.lap("saddle")
            return corners, level
    return None, -1


def find_chessboard_corners(image, gridn_w=10, gridn_h=None, *,
                            max_level=2, response_threshold_rel=0.2,
                            device=None):
    """Detect a gridn_w x gridn_h chessboard corner grid in a grayscale
    image (the mrgingham-equivalent entry point; numpy or a tensor, 8-bit,
    16-bit or float; color is averaged over its channels).

    Runs the ChESS response at decimation level 0, and falls back to
    coarser pyramid levels (like mrgingham's multi-level search) if the
    full grid is not found.  Returns (corners (H*W,2) float64 numpy
    row-major, level int) or (None, -1).  The image work runs on the card
    unless device says otherwise."""
    if gridn_h is None:
        gridn_h = gridn_w
    im0 = _image_tensor(image, resolve_device(device))
    return _find_chessboard_corners(im0, gridn_w, gridn_h, max_level,
                                    response_threshold_rel)


def detect_corners_in_images(image_paths, gridn_w, gridn_h=None, *,
                             max_level=2, device=None):
    """Detect chessboards in image files; returns dict
    filename -> (N,3) [x, y, level] or None (mrgingham CLI equivalent).
    Reads the files with PIL (load_image)."""
    from .image import load_image
    device = resolve_device(device)
    out = {}
    for path in image_paths:
        im = load_image(path, channels=1)
        corners, level = find_chessboard_corners(im, gridn_w, gridn_h,
                                                 max_level=max_level,
                                                 device=device)
        if corners is None:
            out[path] = None
        else:
            lev = np.full((corners.shape[0], 1), float(level))
            out[path] = np.concatenate([corners, lev], axis=1)
    return out
