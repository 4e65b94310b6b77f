"""Dense stereo matching by census costs and semi-global matching (SGM).

Counterpart of ``mrcal_tpu/stereo_sgm.py``, on the entry point's device:

  - census transform: 24 bits of 5x5 neighbourhood comparisons (float32,
    against the edge-padded image), packed into int32;
  - matching cost: the Hamming distance of two census codes by a SWAR
    bit count (shifts, masks and adds on int32; torch has no population
    count), one (D, H, W) volume built by a single gather of the shifted
    columns; columns x < d cost 24;
  - SGM aggregation: the scanline recurrence
        L(d,x) = C(d,x) + min(L(d,x-1), L(d+-1,x-1)+P1, minL+P2) - minL
    along 4 paths (left/right/up/down), a loop over each path's steps
    whose body works on the whole (D, rows) plane at once;
  - winner-take-all (the first minimum, as jnp.argmin), parabola subpixel
    refinement and the left-right consistency check.

Every cost, aggregated cost and disparity is an integer-valued float32
below 2^24 (census costs at most 24, each pass renormalised by its
minimum), so the results are the same in any summation order: the CPU
and the card agree with each other and with the JAX package bit for bit.
"""

import numpy as np
import torch

from ._config import resolve_device

MAXCOST = 24.0


def census_transform(im, window=5, *, device=None):
    """Bit-packed census descriptor per pixel: bit k set iff neighbour k
    is brighter than the center.  window=5 -> 24 bits in an int32.  A
    tensor is transformed where it is, an array on `device` (the card
    unless given "cpu")."""
    if not torch.is_tensor(im):
        im = torch.as_tensor(np.asarray(im), device=resolve_device(device))
    im = im.to(torch.float32)
    H, W = im.shape
    r = window // 2
    pad = torch.nn.functional.pad(im[None, None], (r, r, r, r),
                                  mode="replicate")[0, 0]
    out = torch.zeros((H, W), dtype=torch.int32, device=im.device)
    k = 0
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy == 0 and dx == 0:
                continue
            b = pad[r + dy:r + dy + H, r + dx:r + dx + W] > im
            out |= b.to(torch.int32) << k
            k += 1
    return out


def _popcount(v):
    """The number of set bits of each int32 of v, exact for every int32:
    the low 31 bits by SWAR (no intermediate overflows), plus the sign
    bit."""
    sign = (v < 0).to(torch.int32)
    v = v & 0x7FFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v & 0xFF) + ((v >> 8) & 0xFF) + ((v >> 16) & 0xFF)
            + (v >> 24) + sign)


def census_cost_volume(census0, census1, disparity_min, disparity_max):
    """(D, H, W) float32 Hamming cost: cost[d, y, x] = ham(c0[y,x],
    c1[y,x-d]).  Out-of-frame comparisons (x < d) get the max cost (all
    bits differ)."""
    H, W = census0.shape
    ds = torch.arange(disparity_min, disparity_max + 1,
                      device=census0.device)
    D = len(ds)
    x = torch.arange(W, device=census0.device)
    # the column x - d of census1 (jnp.roll's: wrapping, then masked)
    idx = torch.remainder(x[None, :] - ds[:, None], W)
    shifted = torch.gather(census1.expand(D, H, W), 2,
                           idx[:, None, :].expand(D, H, W))
    cost = _popcount(shifted ^ census0).to(torch.float32)
    return torch.where((x[None, :] >= ds[:, None])[:, None, :], cost,
                       MAXCOST)


def _aggregate_pass(cost, acc, P1, P2, reverse):
    """One SGM pass along the first axis of cost (X, D, R): the scan runs
    along X (backwards if reverse), its body works on the (D, R) plane;
    the aggregated costs are added into acc (X, D, R)."""
    X, D, R = cost.shape
    steps = range(X - 1, -1, -1) if reverse else range(X)
    # L with its end entries repeated above and below (the JAX package's
    # edge terms of L(d+-1))
    Lpad = cost.new_empty((D + 2, R))
    L = Lpad[1:-1]
    nb = cost.new_empty((D, R))
    first = True
    for x in steps:
        if first:
            L.copy_(cost[x])
            first = False
        else:
            minL = torch.amin(L, dim=0, keepdim=True)
            Lpad[0] = L[0]
            Lpad[-1] = L[-1]
            torch.minimum(Lpad[:-2], Lpad[2:], out=nb)
            nb += P1
            torch.minimum(nb, L, out=nb)
            torch.minimum(nb, minL + P2, out=nb)
            # C + min(...) - minL, in the JAX package's order
            torch.add(cost[x], nb, out=nb)
            torch.sub(nb, minL, out=L)
        acc[x] += L


def _sgm_aggregate(cost, P1, P2):
    """4-path SGM aggregation of a (D, H, W) float32 cost volume."""
    P1 = float(P1)
    P2 = float(P2)
    # left->right and right->left: the paths are the rows, the planes
    # (D, H) at each column
    by_col = cost.permute(2, 0, 1).contiguous()                 # (W, D, H)
    acc_col = torch.zeros_like(by_col)
    _aggregate_pass(by_col, acc_col, P1, P2, reverse=False)
    _aggregate_pass(by_col, acc_col, P1, P2, reverse=True)
    del by_col
    # top->down and bottom->up: the paths are the columns, the planes
    # (D, W) at each row
    by_row = cost.permute(1, 0, 2).contiguous()                 # (H, D, W)
    acc = torch.zeros_like(by_row)
    _aggregate_pass(by_row, acc, P1, P2, reverse=False)
    _aggregate_pass(by_row, acc, P1, P2, reverse=True)
    del by_row
    acc += acc_col.permute(2, 1, 0)                             # (H, D, W)
    return acc.permute(1, 0, 2).contiguous()                    # (D, H, W)


def _sgm_disparity(agg, disparity_min, lr_consistency_threshold):
    """Winner-take-all, parabola refinement and the left-right check on
    the aggregated (D, H, W) volume; float32 (H, W), 0 where invalid."""
    D, H, W = agg.shape
    best = torch.argmin(agg, dim=0)                             # (H, W)
    # parabola subpixel refinement on the aggregated costs
    ib = torch.clamp(best, 1, D - 2)[None]
    y0 = torch.gather(agg, 0, ib - 1)[0]
    y1 = torch.gather(agg, 0, ib)[0]
    y2 = torch.gather(agg, 0, ib + 1)[0]
    denom = y0 - 2 * y1 + y2
    ok = torch.abs(denom) > 1e-9
    frac = torch.where(ok, 0.5 * (y0 - y2) / torch.where(ok, denom, 1.0),
                       0.0)
    frac = torch.clamp(frac, -0.5, 0.5)
    displ = (best + disparity_min).to(torch.float32) \
        + torch.where(best == ib[0], frac, 0.0)

    # left-right consistency: the right image's WTA disparity from the
    # SAME aggregated volume: aggR[d, y, x] = agg[d, y, x + d]
    x = torch.arange(W, device=agg.device)
    d = torch.arange(D, device=agg.device)
    xs = torch.clamp(x[None, None, :] + d[:, None, None] + disparity_min,
                     0, W - 1)
    bestR = torch.argmin(torch.gather(agg, 2, xs.expand(D, H, W)), dim=0)
    # check |dispL(x) - dispR(x - dispL(x))| <= threshold
    xl = torch.clamp(x[None, :] - (best + disparity_min), 0, W - 1)
    dR_at = torch.gather(bestR, 1, xl)
    consistent = torch.abs(best - dR_at) <= lr_consistency_threshold
    valid = consistent & (best > 0) & (best < D - 1)
    return torch.where(valid, displ, 0.0)


def _grey(im, device):
    if not torch.is_tensor(im):
        im = torch.as_tensor(np.asarray(im))
    im = im.to(device=device, dtype=torch.float32)
    if im.ndim == 3:
        # the channels' mean, summed in order and divided on the device
        s = im[..., 0]
        for c in range(1, im.shape[-1]):
            s = s + im[..., c]
        im = s / s.new_full((), float(im.shape[-1]))
    return im


def stereo_matching_sgm(rectified0, rectified1, *,
                        disparity_min=0, disparity_max=127,
                        P1=6.0, P2=96.0, lr_consistency_threshold=1,
                        device=None):
    """Dense disparity map from a rectified stereo pair via census+SGM —
    the replacement for mrcal.stereo_matching_libelas (reference:
    stereo-matching-libelas.cc).

    rectified0/1: (H, W) grayscale images (any numeric dtype), or (H, W,
    C) colour ones, averaged to grey.  Returns a float32 (H, W) tensor of
    disparities in pixels on the device; invalid/inconsistent pixels are 0
    (the reference's invalid output).

    P1/P2: SGM smoothness penalties against the 24-bit census Hamming
    cost (P1 small-slant penalty, P2 discontinuity penalty)."""
    device = resolve_device(device)
    disparity_min = int(disparity_min)
    disparity_max = int(disparity_max)
    census0 = census_transform(_grey(rectified0, device))
    census1 = census_transform(_grey(rectified1, device))
    cost = census_cost_volume(census0, census1, disparity_min,
                              disparity_max)
    del census0, census1
    agg = _sgm_aggregate(cost, np.float32(P1), np.float32(P2))
    del cost
    return _sgm_disparity(agg, disparity_min, int(lr_consistency_threshold))
