"""The rotations and rigid transforms of the calibration path, in PyTorch.

Counterpart of the core functions of ``mrcal_tpu/poseutils.py``, with the
same conventions: a rotation is a Rodrigues vector r (axis * angle), an rt
transform is ``[r, t]`` (6,) applied as ``R(r) x + t``, and composing rt0
with rt1 maps coords-2 to coords-0 when rt0 maps 1->0 and rt1 maps 2->1.
Quaternions are (w,x,y,z).

Every function broadcasts over leading dimensions and is differentiable
by autograd everywhere, r = 0 included: the small-angle Taylor branches
take their input from a "safe" copy (``th2_safe``), because
``torch.where`` differentiates both branches and an unguarded sin(th)/th
would put NaN into the gradient at th = 0.
"""

import numpy as np
import torch

from ._config import DEFAULT_DTYPE, resolve_device


def skew_symmetric(v):
    """skew(v) @ x == cross(v, x).  v: (...,3) -> (...,3,3)"""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    O = torch.zeros_like(x)
    return torch.stack([
        torch.stack([O, -z,  y], dim=-1),
        torch.stack([z,  O, -x], dim=-1),
        torch.stack([-y, x,  O], dim=-1)], dim=-2)


def _rodrigues_coeffs(r):
    """a = sin(th)/th, b = (1-cos(th))/th^2 with Taylor fallbacks near 0."""
    th2 = torch.sum(r * r, dim=-1)
    tiny = th2 < 1e-18
    th2_safe = torch.where(tiny, 1.0, th2)
    th = torch.sqrt(th2_safe)
    a = torch.where(tiny, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(tiny, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2_safe)
    return a, b


def _R_from_r(r):
    """Rodrigues rotation vector -> rotation matrix.  (...,3) -> (...,3,3).
    R = I + sin(th)/th K + (1-cos(th))/th^2 K^2 with K = skew(r)."""
    a, b = _rodrigues_coeffs(r)
    K = skew_symmetric(r)
    K2 = K @ K
    I = torch.eye(3, dtype=r.dtype, device=r.device).expand(K.shape)
    return I + a[..., None, None] * K + b[..., None, None] * K2


def _quat_from_r(r):
    th2 = torch.sum(r * r, dim=-1)
    tiny = th2 < 1e-18
    th = torch.sqrt(torch.where(tiny, 1.0, th2))
    half = 0.5 * th
    # sin(th/2)/th with Taylor fallback
    s = torch.where(tiny, 0.5 - th2 / 48.0, torch.sin(half) / th)
    w = torch.where(tiny, 1.0 - th2 / 8.0, torch.cos(half))
    return torch.cat([w[..., None], r * s[..., None]], dim=-1)


def _quat_mul(q0, q1):
    w0, x0, y0, z0 = (q0[..., i] for i in range(4))
    w1, x1, y1, z1 = (q1[..., i] for i in range(4))
    return torch.stack([
        w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1,
        w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1,
        w0 * y1 - x0 * z1 + y0 * w1 + z0 * x1,
        w0 * z1 + x0 * y1 - y0 * x1 + z0 * w1], dim=-1)


def _r_from_quat(q):
    """Unit quaternion (w,x,y,z) -> Rodrigues vector.  (...,4)->(...,3)."""
    w = q[..., 0]
    v = q[..., 1:]
    normv = torch.linalg.vector_norm(v, dim=-1)
    # th = 2*atan2(|v|, w);  r = th * v/|v|
    th = 2.0 * torch.atan2(normv, w)
    tiny = normv < 1e-12
    scale = torch.where(tiny,
                        2.0 / torch.where(torch.abs(w) < 1e-30, 1.0, w),
                        th / torch.where(tiny, 1.0, normv))
    return v * scale[..., None]


def _compose_r(r0, r1):
    """Rodrigues composition r01 such that R(r01) = R(r0) @ R(r1), via
    quaternions."""
    return _r_from_quat(_quat_mul(_quat_from_r(r0), _quat_from_r(r1)))


def _rotate_point_r(r, x, inverted=False):
    """R(r) @ x without materializing R: u = x + a*(r x x) + b*(r x (r x x))."""
    if inverted:
        r = -r
    a, b = _rodrigues_coeffs(r)
    r, x = torch.broadcast_tensors(r, x)
    rx = torch.linalg.cross(r, x, dim=-1)
    rrx = torch.linalg.cross(r, rx, dim=-1)
    return x + a[..., None] * rx + b[..., None] * rrx


def _compose_rt2(rt0, rt1):
    r01 = _compose_r(rt0[..., :3], rt1[..., :3])
    t01 = _rotate_point_r(rt0[..., :3], rt1[..., 3:]) + rt0[..., 3:]
    return torch.cat([r01, t01], dim=-1)


def _invert_rt(rt):
    r = rt[..., :3]
    tinv = -_rotate_point_r(r, rt[..., 3:], inverted=True)
    return torch.cat([-r, tinv], dim=-1)


def _transform_point_rt(rt, x, inverted=False):
    if inverted:
        return _rotate_point_r(rt[..., :3], x - rt[..., 3:], inverted=True)
    return _rotate_point_r(rt[..., :3], x) + rt[..., 3:]


def _finish(result, out):
    """The reference's out= convention: with an out array (or a tuple of
    them) the result is written into it, and it is returned."""
    if out is None:
        return result
    if isinstance(result, tuple):
        for o, res in zip(out, result):
            np.copyto(np.asarray(o), res.detach().cpu().numpy())
        return out
    np.copyto(np.asarray(out), result.detach().cpu().numpy())
    return out


def _as_tensors(device, *arrays):
    """The arrays as tensors on the entry point's device (None: the card,
    as ``resolve_device``), all of the first one's dtype if it is floating
    and float64 otherwise; a None passes through."""
    device = resolve_device(device)

    def tensor(a, **kw):
        if not torch.is_tensor(a):
            a = np.asarray(a)
            if any(st < 0 for st in a.strides):    # torch takes none
                a = a.copy()
        return torch.as_tensor(a, device=device, **kw)

    first = tensor(arrays[0])
    dtype = first.dtype if first.is_floating_point() else DEFAULT_DTYPE
    return tuple(None if a is None else tensor(a, dtype=dtype)
                 for a in arrays)


def _vjac(fn, args, core_dims, argnum):
    """d fn / d args[argnum] by forward mode, for fn a function of single
    samples whose argument i has core_dims[i] trailing dimensions; batched
    over the broadcast leading dimensions of args."""
    core = [a.dim() - d for a, d in zip(args, core_dims)]
    lead = torch.Size(np.broadcast_shapes(*(a.shape[:c]
                                            for a, c in zip(args, core))))
    flat = [a.expand(lead + a.shape[c:]).reshape((-1,) + a.shape[c:])
            for a, c in zip(args, core)]
    J = torch.func.vmap(torch.func.jacfwd(fn, argnums=argnum))(*flat)
    return J.reshape(lead + J.shape[1:])


def _rotate_point_R(R, x, inverted=False):
    if inverted:
        R = R.transpose(-1, -2)
    return torch.einsum("...ij,...j->...i", R, x)


def rotate_point_R(R, x, *, get_gradients=False, out=None, inverted=False,
                   device=None):
    """u = R x (or R^T x).  R: (...,3,3), x: (...,3).  Runs on the card
    unless device says otherwise.

    get_gradients: returns (u, du/dR (...,3,3,3), du/dx (...,3,3))."""
    R, x = _as_tensors(device, R, x)
    u = _rotate_point_R(R, x, inverted)
    if not get_gradients:
        return _finish(u, out)

    def f(R_, x_):
        return _rotate_point_R(R_, x_, inverted)
    return _finish((u, _vjac(f, (R, x), (2, 1), 0),
                    _vjac(f, (R, x), (2, 1), 1)), out)


def R_from_r(r, *, get_gradients=False, out=None, device=None):
    """Rodrigues vector(s) -> rotation matrices.  (...,3) -> (...,3,3).
    Runs on the card unless device says otherwise.

    get_gradients: also returns dR/dr (...,3,3,3)."""
    (r,) = _as_tensors(device, r)
    R = _R_from_r(r)
    if not get_gradients:
        return _finish(R, out)
    return _finish((R, _vjac(_R_from_r, (r,), (1,), 0)), out)


def _two_only(n, what, **flags):
    if any(flags.values()) and n != 2:
        raise ValueError(f"inverted/get_gradients require exactly 2 {what}")


def compose_r(*r, get_gradients=False, out=None, inverted0=False,
              inverted1=False, device=None):
    """Compose Rodrigues rotations left to right.  Each (...,3).  Runs on
    the card unless device says otherwise.

    get_gradients (2 rotations only): returns (r01, dr01/dr0, dr01/dr1),
    the gradients (...,3,3).  inverted0/inverted1 (2 rotations only)
    invert the first/second rotation before composing."""
    _two_only(len(r), "rotations", get_gradients=get_gradients,
              inverted0=inverted0, inverted1=inverted1)
    rs = list(_as_tensors(device, *r))
    if inverted0:
        rs[0] = -rs[0]
    if inverted1:
        rs[1] = -rs[1]
    acc = rs[0]
    for nxt in rs[1:]:
        acc = _compose_r(acc, nxt)
    if not get_gradients:
        return _finish(acc, out)
    dr0 = _vjac(_compose_r, rs, (1, 1), 0)
    dr1 = _vjac(_compose_r, rs, (1, 1), 1)
    return _finish((acc, -dr0 if inverted0 else dr0,
                    -dr1 if inverted1 else dr1), out)


def compose_rt(*rt, get_gradients=False, out=None, inverted0=False,
               inverted1=False, device=None):
    """Compose rt transformations left to right.  Each (...,6).  Runs on
    the card unless device says otherwise.

    get_gradients (2 transforms only): returns (rt01, drt01/drt0,
    drt01/drt1), the gradients (...,6,6), with respect to the arguments
    as given (inverted or not).  inverted0/inverted1 (2 transforms only)
    invert the first/second transform before composing."""
    _two_only(len(rt), "transforms", get_gradients=get_gradients,
              inverted0=inverted0, inverted1=inverted1)
    given = _as_tensors(device, *rt)
    rts = list(given)
    if inverted0:
        rts[0] = _invert_rt(rts[0])
    if inverted1:
        rts[1] = _invert_rt(rts[1])
    acc = rts[0]
    for nxt in rts[1:]:
        acc = _compose_rt2(acc, nxt)
    if not get_gradients:
        return _finish(acc, out)
    d = [_vjac(_compose_rt2, rts, (1, 1), i) for i in (0, 1)]
    for i, inverted in enumerate((inverted0, inverted1)):
        if inverted:
            d[i] = d[i] @ _vjac(_invert_rt, (given[i],), (1,), 0)
    return _finish((acc, d[0], d[1]), out)


def rotate_point_r(r, x, *, get_gradients=False, out=None, inverted=False,
                   device=None):
    """u = R(r) x (or R(r)^T x if inverted).  r, x: (...,3).  Runs on the
    card unless device says otherwise.

    get_gradients: returns (u, du/dr (...,3,3), du/dx (...,3,3))."""
    r, x = _as_tensors(device, r, x)
    u = _rotate_point_r(r, x, inverted)
    if not get_gradients:
        return _finish(u, out)

    def f(r_, x_):
        return _rotate_point_r(r_, x_, inverted)
    return _finish((u, _vjac(f, (r, x), (1, 1), 0),
                    _vjac(f, (r, x), (1, 1), 1)), out)


def transform_point_rt(rt, x, *, get_gradients=False, out=None,
                       inverted=False, device=None):
    """u = R(rt[:3]) x + rt[3:] (the inverse transform if inverted).  rt:
    (...,6), x: (...,3).  Runs on the card unless device says otherwise.

    get_gradients: returns (u, du/drt (...,3,6), du/dx (...,3,3))."""
    rt, x = _as_tensors(device, rt, x)
    u = _transform_point_rt(rt, x, inverted)
    if not get_gradients:
        return _finish(u, out)

    def f(rt_, x_):
        return _transform_point_rt(rt_, x_, inverted)
    return _finish((u, _vjac(f, (rt, x), (1, 1), 0),
                    _vjac(f, (rt, x), (1, 1), 1)), out)
