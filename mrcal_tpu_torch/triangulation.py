"""Two-view triangulation, in PyTorch.

Counterpart of the two-view methods of ``mrcal_tpu/triangulation.py``:
the midpoint (geometric), Lee-Civera L1 / L-infinity / Mid2 / wMid2 and
Lindstrom methods, and the scalar ray-divergence measurement
``_triangulated_error`` that triangulated-point solves minimize.  Each
method is one function of tensors that broadcasts over leading
dimensions; the public wrappers take ``get_gradients=True`` (Jacobians by
``torch.func.jacfwd``) and ``out=``, and run on the card unless given
``device="cpu"``.

All failure cases (divergent rays, chirality violations) return (0,0,0),
as in the reference.
"""

import torch

from .poseutils import _as_tensors, _finish, _rotate_point_R, _vjac


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def _zero_where(cond, m):
    return torch.where(cond[..., None], torch.zeros_like(m), m)


def _parse_args(v1, t01, get_gradients, v_are_local, Rt01):
    """v1 and t01 in camera-0 coordinates, from either t01 or Rt01."""
    if (Rt01 is not None) == (t01 is not None):
        raise ValueError("Exactly one of Rt01 and t01 must be given")
    if v_are_local:
        if get_gradients:
            raise ValueError("get_gradients requires v_are_local=False")
        if Rt01 is None:
            raise ValueError("v_are_local requires Rt01")
        return _rotate_point_R(Rt01[..., :3, :], v1), Rt01[..., 3, :]
    if t01 is None:
        if get_gradients:
            raise ValueError("get_gradients requires t01")
        t01 = Rt01[..., 3, :]
    return v1, t01


# ----------------------------------------------------------------------------
# core methods (v0, v1, t01 all in camera-0 coords)
# ----------------------------------------------------------------------------

def _geometric(v0, v1, t01):
    """Midpoint of the common perpendicular."""
    d00 = _dot(v0, v0)
    d11 = _dot(v1, v1)
    d01 = _dot(v0, v1)
    d0t = _dot(v0, t01)
    d1t = _dot(v1, t01)
    denom = d00 * d11 - d01 * d01
    bad = torch.abs(denom) <= 1e-10
    denom_safe = torch.where(bad, 1.0, denom)
    k0 = (d11 * d0t - d01 * d1t) / denom_safe
    k1 = (d01 * d0t - d00 * d1t) / denom_safe
    m = (v0 * k0[..., None] + v1 * k1[..., None] + t01) * 0.5
    return _zero_where(bad | (k0 <= 0) | (k1 <= 0), m)


def _assume_intersect(v0, v1, t01):
    """Intersect two rays assumed coplanar.  Returns (m, ok)."""
    det_xz = v1[..., 0] * v0[..., 2] - v0[..., 0] * v1[..., 2]
    det_yz = v1[..., 1] * v0[..., 2] - v0[..., 1] * v1[..., 2]
    use_xz = torch.abs(det_xz) > torch.abs(det_yz)

    det = torch.where(use_xz, det_xz, det_yz)
    bad = torch.abs(det) <= 1e-10
    det_safe = torch.where(bad, 1.0, det)

    num_xz = t01[..., 2] * v1[..., 0] - t01[..., 0] * v1[..., 2]
    num_yz = t01[..., 2] * v1[..., 1] - t01[..., 1] * v1[..., 2]
    k0 = torch.where(use_xz, num_xz, num_yz) / det_safe

    k1neg_xz = torch.logical_xor(
        t01[..., 2] * v0[..., 0] > t01[..., 0] * v0[..., 2], det > 0)
    k1neg_yz = torch.logical_xor(
        t01[..., 2] * v0[..., 1] > t01[..., 1] * v0[..., 2], det > 0)
    k1_negative = torch.where(use_xz, k1neg_xz, k1neg_yz)

    ok = (~bad) & (k0 > 0) & (~k1_negative)
    return v0 * k0[..., None], ok


def _chirality(l0, v0, l1, v1, t01):
    """Lee-Civera chirality test."""
    w0, w1, w01 = _chirality_worsenings(l0, v0, l1, v1, t01)
    return (w0 > 0) & (w1 > 0) & (w01 > 0)


def _leecivera_l1(v0, v1, t01):
    """Lee-Civera L1 method."""
    d00 = _dot(v0, v0)
    d11 = _dot(v1, v1)
    d0t = _dot(v0, t01)
    d1t = _dot(v1, t01)
    # project the less-certain ray onto the other's epipolar plane
    use0 = d0t * d0t * d11 > d1t * d1t * d00
    n1 = _cross(v1, t01)
    v0_fix = v0 - n1 * (_dot(v0, n1) / _dot(n1, n1))[..., None]
    n0 = _cross(v0, t01)
    v1_fix = v1 - n0 * (_dot(v1, n0) / _dot(n0, n0))[..., None]
    v0n = torch.where(use0[..., None], v0_fix, v0)
    v1n = torch.where(use0[..., None], v1, v1_fix)
    m, ok = _assume_intersect(v0n, v1n, t01)
    return _zero_where(~ok, m)


def _leecivera_linf(v0, v1, t01):
    """Lee-Civera L-infinity method."""
    v0 = v0 / _norm(v0)[..., None]
    v1 = v1 / _norm(v1)[..., None]
    na = _cross(v0 + v1, t01)
    nb = _cross(v0 - v1, t01)
    use_a = _dot(na, na) > _dot(nb, nb)
    n = torch.where(use_a[..., None], na, nb)
    v0 = v0 - n * (_dot(v0, n) / _dot(n, n))[..., None]
    v1 = v1 - n * (_dot(v1, n) / _dot(n, n))[..., None]
    m, ok = _assume_intersect(v0, v1, t01)
    return _zero_where(~ok, m)


def _leecivera_mid2(v0, v1, t01):
    """Lee-Civera Mid2."""
    p = _cross(v0, v1)
    p_norm2 = _dot(p, p)
    c1 = _cross(v1, t01)
    c0 = _cross(v0, t01)
    l0 = torch.sqrt(_dot(c1, c1) / p_norm2)
    l1 = torch.sqrt(_dot(c0, c0) / p_norm2)
    ok = _chirality(l0, v0, l1, v1, t01)
    m = (v0 * l0[..., None] + t01 + v1 * l1[..., None]) / 2.0
    return _zero_where(~ok, m)


def _leecivera_wmid2(v0, v1, t01):
    """Lee-Civera wMid2."""
    v0 = v0 / _norm(v0)[..., None]
    v1 = v1 / _norm(v1)[..., None]
    p_mag = _norm(_cross(v0, v1))
    l0 = _norm(_cross(v1, t01)) / p_mag
    l1 = _norm(_cross(v0, t01)) / p_mag
    ok = _chirality(l0, v0, l1, v1, t01)
    m = (v0 * (l0 * l1)[..., None] + t01 * l0[..., None]
         + v1 * (l0 * l1)[..., None]) / (l0 + l1)[..., None]
    return _zero_where(~ok, m)


def _lindstrom(v0_local, v1_local, Rt01):
    """Lindstrom's 2-iteration L2-optimal triangulation ("Triangulation
    Made Easy")."""
    R = Rt01[..., :3, :]
    t01 = Rt01[..., 3, :]
    # E = cross-matrix(t01) @ R01, flattened row-major
    tx, ty, tz = t01[..., 0], t01[..., 1], t01[..., 2]
    E = torch.stack([
        R[..., 2, 0] * ty - R[..., 1, 0] * tz,
        R[..., 2, 1] * ty - R[..., 1, 1] * tz,
        R[..., 2, 2] * ty - R[..., 1, 2] * tz,
        R[..., 0, 0] * tz - R[..., 2, 0] * tx,
        R[..., 0, 1] * tz - R[..., 2, 1] * tx,
        R[..., 0, 2] * tz - R[..., 2, 2] * tx,
        R[..., 1, 0] * tx - R[..., 0, 0] * ty,
        R[..., 1, 1] * tx - R[..., 0, 1] * ty,
        R[..., 1, 2] * tx - R[..., 0, 2] * ty], dim=-1)

    x0 = torch.stack([v0_local[..., 0] / v0_local[..., 2],
                      v0_local[..., 1] / v0_local[..., 2]], dim=-1)
    x1 = torch.stack([v1_local[..., 0] / v1_local[..., 2],
                      v1_local[..., 1] / v1_local[..., 2]], dim=-1)

    n0 = E[..., 0] * x1[..., 0] + E[..., 1] * x1[..., 1] + E[..., 2]
    n1 = E[..., 3] * x1[..., 0] + E[..., 4] * x1[..., 1] + E[..., 5]
    nn0 = E[..., 0] * x0[..., 0] + E[..., 3] * x0[..., 1] + E[..., 6]
    nn1 = E[..., 1] * x0[..., 0] + E[..., 4] * x0[..., 1] + E[..., 7]
    a = (n0 * E[..., 0] * nn0 + n0 * E[..., 1] * nn1 +
         n1 * E[..., 3] * nn0 + n1 * E[..., 4] * nn1)
    b = 0.5 * (n0 * n0 + n1 * n1 + nn0 * nn0 + nn1 * nn1)
    n_2 = E[..., 6] * x1[..., 0] + E[..., 7] * x1[..., 1] + E[..., 8]
    c = n0 * x0[..., 0] + n1 * x0[..., 1] + n_2
    d = torch.sqrt(b * b - a * c)
    lam = c / (b + d)
    dx0 = lam * n0
    dx1 = lam * n1
    dxx0 = lam * nn0
    dxx1 = lam * nn1
    n0 = n0 - E[..., 0] * dxx0 - E[..., 1] * dxx1
    n1 = n1 - E[..., 3] * dxx0 - E[..., 4] * dxx1
    nn0 = nn0 - E[..., 0] * dx0 - E[..., 3] * dx1
    nn1 = nn1 - E[..., 1] * dx0 - E[..., 4] * dx1
    bb = 0.5 * (n0 * n0 + n1 * n1 + nn0 * nn0 + nn1 * nn1)
    lam = lam / d * bb
    dx0 = lam * n0
    dx1 = lam * n1
    dxx0 = lam * nn0
    dxx1 = lam * nn1
    v0 = torch.stack([x0[..., 0] - dx0, x0[..., 1] - dx1,
                      torch.ones_like(dx0)], dim=-1)
    v1 = torch.stack([x1[..., 0] - dxx0, x1[..., 1] - dxx1,
                      torch.ones_like(dx0)], dim=-1)
    Rv1 = torch.einsum("...ij,...j->...i", R, v1)
    m, ok = _assume_intersect(v0, Rv1, t01)
    return _zero_where(~ok, m)


# ----------------------------------------------------------------------------
# public API
# ----------------------------------------------------------------------------

def _public(corefn, v0, v1, t01, get_gradients, v_are_local, Rt01, out,
            device):
    v0, v1, t01, Rt01 = _as_tensors(device, v0, v1, t01, Rt01)
    v1, t01 = _parse_args(v1, t01, get_gradients, v_are_local, Rt01)
    m = corefn(v0, v1, t01)
    if not get_gradients:
        return _finish(m, out)
    args = (v0, v1, t01)
    return _finish((m,) + tuple(_vjac(corefn, args, (1, 1, 1), i)
                                for i in range(3)), out)


def triangulate_geometric(v0, v1, t01=None, *, get_gradients=False,
                          v_are_local=False, Rt01=None, out=None,
                          device=None):
    """Classic midpoint triangulation."""
    return _public(_geometric, v0, v1, t01, get_gradients, v_are_local,
                   Rt01, out, device)


def triangulate_leecivera_l1(v0, v1, t01=None, *, get_gradients=False,
                             v_are_local=False, Rt01=None, out=None,
                             device=None):
    """Lee-Civera L1 triangulation."""
    return _public(_leecivera_l1, v0, v1, t01, get_gradients, v_are_local,
                   Rt01, out, device)


def triangulate_leecivera_linf(v0, v1, t01=None, *, get_gradients=False,
                               v_are_local=False, Rt01=None, out=None,
                               device=None):
    """Lee-Civera L-infinity triangulation."""
    return _public(_leecivera_linf, v0, v1, t01, get_gradients, v_are_local,
                   Rt01, out, device)


def triangulate_leecivera_mid2(v0, v1, t01=None, *, get_gradients=False,
                               v_are_local=False, Rt01=None, out=None,
                               device=None):
    """Lee-Civera Mid2 triangulation, the method triangulated-point solves
    use."""
    return _public(_leecivera_mid2, v0, v1, t01, get_gradients, v_are_local,
                   Rt01, out, device)


def triangulate_leecivera_wmid2(v0, v1, t01=None, *, get_gradients=False,
                                v_are_local=False, Rt01=None, out=None,
                                device=None):
    """Lee-Civera wMid2 triangulation."""
    return _public(_leecivera_wmid2, v0, v1, t01, get_gradients, v_are_local,
                   Rt01, out, device)


def triangulate_lindstrom(v0, v1, Rt01, *, get_gradients=False, out=None,
                          device=None):
    """Lindstrom-optimal L2 triangulation.  v0/v1 are in their LOCAL camera
    coordinates (unlike the other methods)."""
    v0, v1, Rt01 = _as_tensors(device, v0, v1, Rt01)
    m = _lindstrom(v0, v1, Rt01)
    if not get_gradients:
        return _finish(m, out)
    args = (v0, v1, Rt01)
    return _finish((m,) + tuple(_vjac(_lindstrom, args, (1, 1, 2), i)
                                for i in range(3)), out)


# ----------------------------------------------------------------------------
# the triangulated-point measurement
# ----------------------------------------------------------------------------

def _angle_error_small(v0, v1):
    """Small-angle error between two rays: th ~ sqrt(2 (1 - |cos th|)).
    The tiny epsilon keeps the sqrt differentiable at perfect
    convergence.

    2 (1 - |cos th|) is computed as |u0 - s u1|^2, with u the unit rays
    and s the sign of cos th: the same value, without the cancellation of
    1 - |cos th|, which leaves an error of ~eps/th^2 relative (2e-8 at the
    1e-4 rad of a converged solve).  With it, E is noise at the optimum
    and the LM loop's accept/reject decisions there follow the summation
    order."""
    u0 = v0 / _norm(v0)[..., None]
    u1 = v1 / _norm(v1)[..., None]
    s = torch.where(_dot(u0, u1) < 0, -1.0, 1.0)
    d = u0 - s[..., None] * u1
    return torch.sqrt(_dot(d, d) + 1e-24)


def _sigmoid_knee(x, knee):
    """Smooth 0..1 ramp over [0, knee]."""
    a = 2.0 / (knee * knee)
    b = 2.0 / knee
    dx = x - knee / 2.0
    lower = a * dx * dx + b * dx + 0.5
    upper = -a * dx * dx + b * dx + 0.5
    mid = torch.where(x < knee / 2.0, lower, upper)
    return torch.where(x <= 0.0, 0.0, torch.where(x >= knee, 1.0, mid))


def _chirality_worsenings(l0, v0, l1, v1, t01):
    x_nom = l1[..., None] * v1 + t01 - l0[..., None] * v0
    x0 = l1[..., None] * v1 + t01 + l0[..., None] * v0
    x1 = -l1[..., None] * v1 + t01 - l0[..., None] * v0
    x01 = -l1[..., None] * v1 + t01 + l0[..., None] * v0
    nom2 = _dot(x_nom, x_nom)
    return (_dot(x0, x0) - nom2, _dot(x1, x1) - nom2,
            _dot(x01, x01) - nom2)


def _triangulated_error(v0, v1, t01):
    """The scalar ray-divergence measurement of triangulated-point solves:
    2x the small-angle error between v0 and the mid2 reconstruction, plus
    a smooth divergence penalty when chirality fails."""
    p = _cross(v0, v1)
    p_norm2 = _dot(p, p)
    c1 = _cross(v1, t01)
    c0 = _cross(v0, t01)
    l0 = torch.sqrt(_dot(c1, c1) / p_norm2)
    l1 = torch.sqrt(_dot(c0, c0) / p_norm2)
    m = (v0 * l0[..., None] + t01 + v1 * l1[..., None]) / 2.0
    err = _angle_error_small(v0, m) * 2.0
    w0, w1, w01 = _chirality_worsenings(l0, v0, l1, v1, t01)
    err_vanish = _angle_error_small(v0, v1)
    penalty = (_sigmoid_knee(-w0, 3.0) + _sigmoid_knee(-w1, 3.0)
               + _sigmoid_knee(-w01, 3.0))
    return err + err_vanish * penalty
