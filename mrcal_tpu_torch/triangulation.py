"""Two-view triangulation, in PyTorch.

Counterpart of ``mrcal_tpu/triangulation.py``.  The two-view methods:
the midpoint (geometric), Lee-Civera L1 / L-infinity / Mid2 / wMid2 and
Lindstrom methods, and the scalar ray-divergence measurement
``_triangulated_error`` that triangulated-point solves minimize.  Each
method is one function of tensors that broadcasts over leading
dimensions; the public wrappers take ``get_gradients=True`` (Jacobians by
``torch.func.jacfwd``) and ``out=``, and run on the card unless given
``device="cpu"``.

``triangulate`` takes pixel observations and two cameramodels, and
propagates calibration-time noise (through the solve that made the
models, as ``model_analysis`` does; the points' full cross-covariance)
and observation-time noise into the triangulated points.

All failure cases (divergent rays, chirality violations) return (0,0,0),
as in the reference.
"""

import numpy as np
import torch

from . import lensmodels as _lm
from .lensmodels import (parse_lensmodel, project_core,
                         stereographic_v_from_uv, unproject_core)
from .poseutils import (_as_tensors, _compose_Rt2, _compose_rt2, _finish,
                        _invert_Rt, _invert_rt, _rotate_point_r,
                        _rotate_point_R, _transform_point_rt, _vjac)


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


# ----------------------------------------------------------------------------
# triangulate(): two cameramodels, and the uncertainty of the points
# ----------------------------------------------------------------------------

# the public methods triangulate() takes, and their functions of tensors
_METHODS = {triangulate_geometric: _geometric,
            triangulate_leecivera_l1: _leecivera_l1,
            triangulate_leecivera_linf: _leecivera_linf,
            triangulate_leecivera_mid2: _leecivera_mid2,
            triangulate_leecivera_wmid2: _leecivera_wmid2,
            triangulate_lindstrom: _lindstrom}


def _linearization(q, intrinsics, lm, v=None):
    """What _unproject_linear needs to unproject near (q, intrinsics),
    given v = unproject_core(q, intrinsics) if it is known: None for the
    closed-form models; else (intrinsics, u0, inv(dq/du), r0) at the
    converged normalized stereographic u0 = v[..., :2] of each q, with r0
    its reprojection's residual."""
    if lm.family in _lm._CLOSED_FORM_UNPROJECT:
        return None
    if v is None:
        v = unproject_core(q, intrinsics, lm)
    u0 = v[..., :2]

    def h(u, i):
        return project_core(stereographic_v_from_uv(u), i, lm)
    dq_du = _vjac(h, (u0, intrinsics), (1, 1), 0)
    return intrinsics, u0, torch.linalg.inv(dq_du), h(u0, intrinsics) - q


def _linearization_at(lin, q, intrinsics, lm):
    """lin if it was made at these intrinsics, else a new linearization
    there: a model's intrinsics may have been changed after its solve."""
    if lin is not None and lin[0].shape == intrinsics.shape \
            and torch.equal(lin[0], intrinsics):
        return lin
    return _linearization(q, intrinsics, lm)


def _unproject_linear(q, intrinsics, lin, lm):
    """unproject_core(q, intrinsics) for a function that torch.func
    differentiates.  The iterative unprojections carry no autograd graph,
    so near the point `lin` was made at, u is one Newton step from the
    converged u0: u = u0 - inv(dq/du) (h(u0, intrinsics) - q - r0).  At
    that point u = u0, and its first derivatives are those of the
    implicit function theorem, du/dq = inv(dq/du) and du/di = -inv(dq/du)
    dh/di."""
    if lin is None:
        return unproject_core(q, intrinsics, lm)
    _, u0, dq_du_inv, r0 = lin
    du = torch.einsum("...ij,...j->...i", dq_du_inv,
                      project_core(stereographic_v_from_uv(u0), intrinsics,
                                   lm) - q - r0)
    return stereographic_v_from_uv(u0 - du)


def _model_tensors(model, device):
    """(lens model, intrinsics, Rt_cam_ref) of a cameramodel, on device."""
    lens, intr = model.intrinsics()
    return (parse_lensmodel(lens),
            torch.as_tensor(np.asarray(intr, np.float64), device=device),
            torch.as_tensor(model.Rt_cam_ref(), device=device))


def triangulate(q, models, *, stabilize_coords=True, method=None,
                q_calibration_stdev=None, q_observation_stdev=None,
                q_observation_stdev_correlation=0.0, device=None):
    """Triangulate features observed by two cameras, optionally with the
    uncertainty of the points under calibration-time and observation-time
    pixel noise.

    q: (..., 2, 2) pixel observations, q[..., 0, :] in camera 0 and
    q[..., 1, :] in camera 1, broadcasting over the leading dims.  models:
    two cameramodels; with q_calibration_stdev, both from one solve (the
    same optimization_inputs).  method: one of the triangulate_*
    functions of this module (triangulate_leecivera_mid2 by default);
    triangulate_lindstrom takes the rays in their local cameras and gives
    no uncertainty.  The points are in camera 0's coordinates.

    Returns, as tensors on the device (the card unless given "cpu"):
      neither stdev:     p (..., 3)
      calibration only:  p, Var_p_calibration (..., 3, ..., 3)
      observation only:  p, Var_p_observation (..., 3, 3)
      both:              p, Var_p_calibration, Var_p_observation,
                         Var_p_joint (..., 3, ..., 3)
    Var_p_calibration holds the cross-point correlations of the shared
    calibration; Var_p_observation is per point (independent pixel
    noise of q_observation_stdev px in each observation, correlated by
    q_observation_stdev_correlation between the two cameras' x and
    between their y); Var_p_joint is their sum.  A stdev of 0 gives zeros
    of the right shape.

    stabilize_coords: the calibration noise moves camera 0's coordinate
    system; carry each perturbed point through the perturbed frames, which
    are fixed in space, and back through the baseline ones."""
    if method is None:
        method = triangulate_leecivera_mid2
    core = _METHODS.get(method)
    if core is None:
        raise ValueError(f"Unknown triangulation method {method!r}: pass "
                         "one of the triangulate_* functions")
    if method is triangulate_lindstrom and (
            q_calibration_stdev is not None
            or q_observation_stdev is not None):
        raise Exception(
            "Triangulation gradients are not supported with "
            "method=triangulate_lindstrom (it takes other inputs)")
    (q,) = _as_tensors(device, q)
    lead = q.shape[:-2]
    cams = [_model_tensors(m, q.device) for m in models]
    Rt01 = _compose_Rt2(cams[0][2], _invert_Rt(cams[1][2]))
    v_local = [unproject_core(q[..., i, :], intr, lm)
               for i, (lm, intr, _) in enumerate(cams)]
    if method is triangulate_lindstrom:
        return _lindstrom(*v_local, Rt01)
    p = core(v_local[0], _rotate_point_R(Rt01[:3, :], v_local[1]),
             Rt01[3, :])
    if q_calibration_stdev is None and q_observation_stdev is None:
        return p

    for name, stdev in (("q_calibration_stdev", q_calibration_stdev),
                        ("q_observation_stdev", q_observation_stdev)):
        if stdev is not None and stdev < 0:
            raise Exception(f"{name} MUST be None or >= 0")
    q2 = q.reshape(-1, 2, 2)
    N = q2.shape[0]
    # one unprojection of each camera's q serves p and both Jacobians
    lins = [_linearization(q2[:, i], intr, lm, v.reshape(-1, 3))
            for i, ((lm, intr, _), v) in enumerate(zip(cams, v_local))]

    Var_obs = None
    if q_observation_stdev is not None:
        Var_obs = q.new_zeros(lead + (3, 3))
        if q_observation_stdev > 0:
            Var_obs = _Var_observation(
                q2, cams, lins, Rt01, core, q_observation_stdev,
                q_observation_stdev_correlation).reshape(lead + (3, 3))

    Var_cal = None
    if q_calibration_stdev is not None:
        Var_cal = q.new_zeros(lead + (3,) + lead + (3,))
        if q_calibration_stdev > 0:
            Var_cal = _triangulation_Var_calibration(
                q2, models, core, q_calibration_stdev,
                stabilize_coords=stabilize_coords, lins=lins
            ).reshape(lead + (3,) + lead + (3,))

    if Var_cal is None:
        return p, Var_obs
    if Var_obs is None:
        return p, Var_cal
    # calibration (correlated across points) + observation (per point, on
    # the block diagonal)
    Var_joint = Var_cal.reshape(N, 3, N, 3).clone()
    i = torch.arange(N, device=q.device)
    Var_joint[i, :, i, :] += Var_obs.reshape(N, 3, 3)
    return p, Var_cal, Var_obs, Var_joint.reshape(lead + (3,) + lead + (3,))


def _Var_observation(q2, cams, lins, Rt01, core, stdev, rho):
    """Var (N, 3, 3) of the N points triangulated from q2 (N, 2, 2) under
    independent pixel noise of `stdev` in each observation, correlated by
    rho between the two cameras' x and between their y: the Jacobian of
    the whole unproject -> rotate -> `core` chain of each pair (a vmap of
    jacfwd) through that 4x4 covariance.  cams: (lens model, intrinsics,
    Rt_cam_ref) of each camera; lins: their linearizations at q2."""
    (lm0, intr0, _), (lm1, intr1, _) = cams

    def ptri(q01, l0, l1):
        v0 = _unproject_linear(q01[0], intr0, l0, lm0)
        v1 = _unproject_linear(q01[1], intr1, l1, lm1)
        return core(v0, _rotate_point_R(Rt01[:3, :], v1), Rt01[3, :])

    dims = tuple(None if lin is None else (None, 0, 0, 0) for lin in lins)
    J = torch.func.vmap(torch.func.jacfwd(ptri),
                        in_dims=(0,) + dims)(q2, *lins)
    Jf = J.reshape(-1, 3, 4)                 # (N, 3, [q0x q0y q1x q1y])
    C = torch.eye(4, dtype=q2.dtype, device=q2.device)
    C[0, 2] = C[2, 0] = C[1, 3] = C[3, 1] = rho
    return stdev ** 2 * torch.einsum("nia,ab,njb->nij", Jf, C, Jf)


def _stationary_cameras(kw, models):
    """(icam_intrinsics, icam_extrinsics) of each model in the solve
    kw; -1 at the reference.  A moving camera raises."""
    from .optimize.layout import camera_extrinsics_indices
    icams = []
    for m in models:
        ici = m.icam_intrinsics() or 0
        try:
            ices = camera_extrinsics_indices(ici, **kw)
        except ValueError:
            ices = np.array([-1])
        if ices.size != 1:
            raise Exception("triangulate() calibration-noise propagation "
                            "needs stationary cameras (one extrinsics "
                            "index per camera)")
        icams.append((ici, int(ices[0])))
    return icams


def _dp_db_map(prob, q2, icams, core, stabilize_coords=True,
               lins=(None, None)):
    """F(db) (N, 3): the N points triangulated from q2 (N, 2, 2) as
    functions of a perturbation db of the packed state of the solved
    problem `prob` (``model_analysis._Solved``): unprojected with the
    perturbed intrinsics, the ray of camera 1 rotated into camera 0 by the
    perturbed extrinsics, triangulated by `core`.  lins: each camera's
    linearization at q2, if known.

    stabilize_coords (with optimized frames): the perturbed point is
    carried from the perturbed camera 0 to the perturbed reference,
    through each perturbed frame into the board's coordinates, which are
    fixed in space, and back through the baseline frame and the baseline
    camera 0; averaged over the frames."""
    from .optimize.residuals import params_from_arrays, split_packed_state
    spec, arrays, b0 = prob.spec, prob.arrays, prob.b
    lm = spec.lensmodel
    base = params_from_arrays(arrays)
    (ici0, ice0), (ici1, ice1) = icams
    lin0, lin1 = (_linearization_at(lin, q2[:, i], base["intrinsics"][ici],
                                    lm)
                  for i, (lin, (ici, _)) in enumerate(zip(lins, icams)))
    stabilize = (stabilize_coords and spec.selections.do_optimize_frames
                 and base["frames"] is not None and base["frames"].numel())
    if stabilize:
        frames0 = base["frames"]
        rt00 = (base["extrinsics"][ice0] if ice0 >= 0
                else b0.new_zeros(6))

    def F(db):
        params = split_packed_state(b0 + db, arrays, spec)
        ext = torch.cat([b0.new_zeros((1, 6)), params["extrinsics"]])
        rt0 = ext[ice0 + 1]
        rt1 = ext[ice1 + 1]
        v0 = _unproject_linear(q2[:, 0], params["intrinsics"][ici0], lin0,
                               lm)
        v1 = _unproject_linear(q2[:, 1], params["intrinsics"][ici1], lin1,
                               lm)
        rt01 = _compose_rt2(rt0, _invert_rt(rt1))
        p_cam = core(v0, _rotate_point_r(rt01[:3], v1), rt01[3:])
        if not stabilize:
            return p_cam
        p_ref = _transform_point_rt(rt0, p_cam, inverted=True)
        p_frames = _transform_point_rt(params["frames"][:, None],
                                       p_ref[None], inverted=True)
        p_ref0 = torch.mean(_transform_point_rt(frames0[:, None], p_frames),
                            dim=0)
        return _transform_point_rt(rt00, p_ref0)

    return F


def _dp_db(prob, q2, icams, core, stabilize_coords=True, lins=(None, None)):
    """dp/db (N, 3, Nstate) of _dp_db_map's F at db = 0, in reverse mode
    as the JAX package takes it: on an H100 at stereo_opencv8_2cam's
    Nstate of 536 it was faster than forward mode at 500 points and at 5
    (``chip_smoke.py`` times both; PERF.md section 6).  Its memory grows
    with the square of the points, as the stabilization carries 3N
    cotangents through every frame: at 500 points its peak is about twice
    forward mode's."""
    F = _dp_db_map(prob, q2, icams, core, stabilize_coords, lins)
    return torch.func.jacrev(F)(prob.b.new_zeros(prob.spec.Nstate))


def _triangulation_Var_calibration(q2, models, core, q_calibration_stdev,
                                   stabilize_coords=True, lins=(None, None)):
    """Var (N, 3, N, 3) of the N points triangulated from q2 (N, 2, 2)
    under pixel noise of q_calibration_stdev in the observations of the
    solve that made both models: dp/db for all N points as one (3N,
    Nstate) block through the propagation of ``model_analysis``, so the
    cross-point correlations stay.  On q2's device."""
    from .model_analysis import _propagate, _Solved
    kw = models[0].optimization_inputs()
    if kw is None:
        raise Exception("q_calibration_stdev requires models with "
                        "optimization_inputs")
    prob = _Solved(kw, q2.device)
    icams = _stationary_cameras(prob.kw, models)
    dp = _dp_db(prob, q2, icams, core, stabilize_coords, lins)
    N = q2.shape[0]
    return _propagate(prob, dp.reshape(3 * N, -1),
                      q_calibration_stdev).reshape(N, 3, N, 3)
