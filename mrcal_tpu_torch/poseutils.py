"""Rotations and rigid transforms, in PyTorch.

Counterpart of ``mrcal_tpu/poseutils.py``, with the same conventions: a
rotation is a (3,3) matrix R or a Rodrigues vector r (axis * angle), an rt
transform is ``[r, t]`` (6,) applied as ``R(r) x + t``, an Rt transform is
(4,3) with R on top and t in the last row, and composing rt0 with rt1 maps
coords-2 to coords-0 when rt0 maps 1->0 and rt1 maps 2->1.  Quaternions
are (w,x,y,z).  The public functions take numpy arrays or tensors, run on
the card unless given ``device="cpu"``, and return tensors.

Every function broadcasts over leading dimensions and is differentiable
by autograd everywhere, r = 0 included: the small-angle Taylor branches
take their input from a "safe" copy (``th2_safe``), because
``torch.where`` differentiates both branches and an unguarded sin(th)/th
would put NaN into the gradient at th = 0.
"""

import numpy as np
import torch

from ._config import DEFAULT_DTYPE, resolve_device

__all__ = [
    "identity_R", "identity_r", "identity_Rt", "identity_rt", "identity_qt",
    "skew_symmetric",
    "r_from_R", "R_from_r", "invert_R",
    "rt_from_Rt", "Rt_from_rt", "invert_Rt", "invert_rt",
    "compose_Rt", "compose_r", "compose_rt",
    "compose_r_tinyr0_gradientr0", "compose_r_tinyr1_gradientr1",
    "compose_rt_tinyrt0_gradientrt0", "compose_rt_tinyrt1_gradientrt1",
    "rotate_point_r", "rotate_point_R",
    "transform_point_rt", "transform_point_Rt",
    "qt_from_Rt", "Rt_from_qt", "quat_from_R", "R_from_quat",
    "R_aligned_to_vector",
]


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
            # torch takes no negative strides, and warns on read-only data
            if any(st < 0 for st in a.strides) or not a.flags.writeable:
                a = a.copy()
        return torch.as_tensor(a, device=device, **kw)

    first = tensor(arrays[0])
    dtype = first.dtype if first.is_floating_point() else DEFAULT_DTYPE
    return tuple(None if a is None else tensor(a, dtype=dtype)
                 for a in arrays)


def _vjac(fn, args, core_dims, argnum, jac=torch.func.jacfwd):
    """d fn / d args[argnum] (by forward mode, or by `jac`), for fn a
    function of single samples whose argument i has core_dims[i] trailing
    dimensions; batched over the broadcast leading dimensions of args."""
    core = [a.dim() - d for a, d in zip(args, core_dims)]
    lead = torch.Size(np.broadcast_shapes(*(a.shape[:c]
                                            for a, c in zip(args, core))))
    flat = [a.expand(lead + a.shape[c:]).reshape((-1,) + a.shape[c:])
            for a, c in zip(args, core)]
    J = torch.func.vmap(jac(fn, argnums=argnum))(*flat)
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


# ----------------------------------------------------------------------------
# identities
# ----------------------------------------------------------------------------

def _identity(make, dtype, device):
    return make(dtype or DEFAULT_DTYPE, resolve_device(device))


def identity_R(dtype=None, *, device=None):
    return _identity(lambda dt, dev: torch.eye(3, dtype=dt, device=dev),
                     dtype, device)


def identity_r(dtype=None, *, device=None):
    return _identity(lambda dt, dev: torch.zeros(3, dtype=dt, device=dev),
                     dtype, device)


def identity_Rt(dtype=None, *, device=None):
    return _identity(lambda dt, dev: torch.cat(
        [torch.eye(3, dtype=dt, device=dev),
         torch.zeros((1, 3), dtype=dt, device=dev)]), dtype, device)


def identity_rt(dtype=None, *, device=None):
    return _identity(lambda dt, dev: torch.zeros(6, dtype=dt, device=dev),
                     dtype, device)


def identity_qt(dtype=None, *, device=None):
    return _identity(lambda dt, dev: torch.tensor(
        [1., 0., 0., 0., 0., 0., 0.], dtype=dt, device=dev), dtype, device)


# ----------------------------------------------------------------------------
# rotation matrices, Rt transforms and quaternions
# ----------------------------------------------------------------------------

def _quat_from_R(R):
    """Rotation matrix -> unit quaternion (w,x,y,z), w >= 0.  Shepperd's
    method without branches: the four candidates from the four pivots (the
    trace and the diagonal), the one of the largest pivot selected."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp_min(x, 1e-30))

    s0 = safe_sqrt(1.0 + tr)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22)
    s2 = safe_sqrt(1.0 - m00 + m11 - m22)
    s3 = safe_sqrt(1.0 - m00 - m11 + m22)
    cand = torch.stack([
        torch.stack([s0, (m21 - m12) / s0, (m02 - m20) / s0,
                     (m10 - m01) / s0], dim=-1),
        torch.stack([(m21 - m12) / s1, s1, (m01 + m10) / s1,
                     (m02 + m20) / s1], dim=-1),
        torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, s2,
                     (m12 + m21) / s2], dim=-1),
        torch.stack([(m10 - m01) / s3, (m02 + m20) / s3,
                     (m12 + m21) / s3, s3], dim=-1)], dim=-2)
    best = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    q = torch.take_along_dim(cand, best[..., None, None], dim=-2)[..., 0, :]
    q = q * 0.5
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def _r_from_R(R):
    return _r_from_quat(_quat_from_R(R))


def _R_from_quat(q):
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = (q[..., i] for i in range(4))
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1)], dim=-2)


def _Rt_from_rt(rt):
    return torch.cat([_R_from_r(rt[..., :3]), rt[..., None, 3:]], dim=-2)


def _rt_from_Rt(Rt):
    return torch.cat([_r_from_R(Rt[..., :3, :]), Rt[..., 3, :]], dim=-1)


def _invert_Rt(Rt):
    """inv([R; t]) = [R^T; -R^T t]."""
    Rinv = Rt[..., :3, :].transpose(-1, -2)
    tinv = -torch.einsum("...ij,...j->...i", Rinv, Rt[..., 3, :])
    return torch.cat([Rinv, tinv[..., None, :]], dim=-2)


def _compose_Rt2(Rt0, Rt1):
    R0 = Rt0[..., :3, :]
    t01 = torch.einsum("...ij,...j->...i", R0, Rt1[..., 3, :]) + Rt0[..., 3, :]
    return torch.cat([R0 @ Rt1[..., :3, :], t01[..., None, :]], dim=-2)


def _transform_point_Rt(Rt, x, inverted=False):
    R = Rt[..., :3, :]
    t = Rt[..., 3, :]
    if inverted:
        return torch.einsum("...ji,...j->...i", R, x - t)
    return torch.einsum("...ij,...j->...i", R, x) + t


# ----------------------------------------------------------------------------
# public API (the JAX package's signatures, plus device)
# ----------------------------------------------------------------------------

def r_from_R(R, *, get_gradients=False, out=None, device=None):
    """Rotation matrices -> Rodrigues vectors.  (...,3,3) -> (...,3).

    get_gradients: also returns dr/dR (...,3,3,3)."""
    (R,) = _as_tensors(device, R)
    r = _r_from_R(R)
    if not get_gradients:
        return _finish(r, out)
    return _finish((r, _vjac(_r_from_R, (R,), (2,), 0)), out)


def invert_R(R, *, out=None, device=None):
    (R,) = _as_tensors(device, R)
    return _finish(R.transpose(-1, -2).contiguous(), out)


def rt_from_Rt(Rt, *, get_gradients=False, out=None, device=None):
    """(...,4,3) Rt -> (...,6) rt.  get_gradients: also dr/dR
    (...,3,3,3)."""
    (Rt,) = _as_tensors(device, Rt)
    rt = _rt_from_Rt(Rt)
    if not get_gradients:
        return _finish(rt, out)
    return _finish((rt, _vjac(_r_from_R, (Rt[..., :3, :],), (2,), 0)), out)


def Rt_from_rt(rt, *, get_gradients=False, out=None, device=None):
    """(...,6) rt -> (...,4,3) Rt.  get_gradients: also dR/dr
    (...,3,3,3)."""
    (rt,) = _as_tensors(device, rt)
    Rt = _Rt_from_rt(rt)
    if not get_gradients:
        return _finish(Rt, out)
    return _finish((Rt, _vjac(_R_from_r, (rt[..., :3],), (1,), 0)), out)


def invert_Rt(Rt, *, out=None, device=None):
    """inv([R; t]) = [R^T; -R^T t].  (...,4,3) -> (...,4,3)."""
    (Rt,) = _as_tensors(device, Rt)
    return _finish(_invert_Rt(Rt), out)


def invert_rt(rt, *, get_gradients=False, out=None, device=None):
    """(...,6) -> (...,6).  get_gradients: also drt_out/drt_in
    (...,6,6)."""
    (rt,) = _as_tensors(device, rt)
    rt_out = _invert_rt(rt)
    if not get_gradients:
        return _finish(rt_out, out)
    return _finish((rt_out, _vjac(_invert_rt, (rt,), (1,), 0)), out)


def compose_Rt(*Rt, out=None, inverted0=False, inverted1=False,
               device=None):
    """Compose Rt transformations left to right.  Each (...,4,3).
    inverted0/inverted1 (2 transforms only) invert the first/second before
    composing."""
    _two_only(len(Rt), "transforms", inverted0=inverted0,
              inverted1=inverted1)
    Rts = list(_as_tensors(device, *Rt))
    if inverted0:
        Rts[0] = _invert_Rt(Rts[0])
    if inverted1:
        Rts[1] = _invert_Rt(Rts[1])
    acc = Rts[0]
    for nxt in Rts[1:]:
        acc = _compose_Rt2(acc, nxt)
    return _finish(acc, out)


def transform_point_Rt(Rt, x, *, get_gradients=False, out=None,
                       inverted=False, device=None):
    """u = R x + t with Rt = [R; t] (...,4,3) (the inverse transform if
    inverted).  get_gradients: returns (u, du/dRt (...,3,4,3), du/dx
    (...,3,3))."""
    Rt, x = _as_tensors(device, Rt, x)
    u = _transform_point_Rt(Rt, x, inverted)
    if not get_gradients:
        return _finish(u, out)

    def f(Rt_, x_):
        return _transform_point_Rt(Rt_, x_, inverted)
    return _finish((u, _vjac(f, (Rt, x), (2, 1), 0),
                    _vjac(f, (Rt, x), (2, 1), 1)), out)


def _tiny_gradient(core, a, argnum, out, device):
    """d core(x0, x1)/d x_argnum at x_argnum = 0, the other argument a."""
    (a,) = _as_tensors(device, a)
    args = [a, a]
    args[argnum] = torch.zeros_like(a)
    return _finish(_vjac(core, tuple(args), (1, 1), argnum), out)


def compose_r_tinyr0_gradientr0(r1, *, out=None, device=None):
    """d compose_r(r0, r1)/dr0 at r0 = 0.  (...,3) -> (...,3,3)."""
    return _tiny_gradient(_compose_r, r1, 0, out, device)


def compose_r_tinyr1_gradientr1(r0, *, out=None, device=None):
    """d compose_r(r0, r1)/dr1 at r1 = 0.  (...,3) -> (...,3,3)."""
    return _tiny_gradient(_compose_r, r0, 1, out, device)


def compose_rt_tinyrt0_gradientrt0(rt1, *, out=None, device=None):
    """d compose_rt(rt0, rt1)/drt0 at rt0 = 0.  (...,6) -> (...,6,6)."""
    return _tiny_gradient(_compose_rt2, rt1, 0, out, device)


def compose_rt_tinyrt1_gradientrt1(rt0, *, out=None, device=None):
    """d compose_rt(rt0, rt1)/drt1 at rt1 = 0.  (...,6) -> (...,6,6)."""
    return _tiny_gradient(_compose_rt2, rt0, 1, out, device)


def quat_from_R(R, *, out=None, device=None):
    """(...,3,3) -> unit quaternion (...,4), (w,x,y,z), w >= 0."""
    (R,) = _as_tensors(device, R)
    return _finish(_quat_from_R(R), out)


def R_from_quat(q, *, out=None, device=None):
    """(...,4) (w,x,y,z), normalized first -> (...,3,3)."""
    (q,) = _as_tensors(device, q)
    return _finish(_R_from_quat(q), out)


def qt_from_Rt(Rt, *, out=None, device=None):
    """(...,4,3) Rt -> (...,7) qt = [quaternion (w,x,y,z), t]."""
    (Rt,) = _as_tensors(device, Rt)
    return _finish(torch.cat([_quat_from_R(Rt[..., :3, :]), Rt[..., 3, :]],
                             dim=-1), out)


def Rt_from_qt(qt, *, out=None, device=None):
    """(...,7) qt -> (...,4,3) Rt."""
    (qt,) = _as_tensors(device, qt)
    return _finish(torch.cat([_R_from_quat(qt[..., :4]), qt[..., None, 4:]],
                             dim=-2), out)


def R_aligned_to_vector(v, *, device=None):
    """An orthonormal R whose third row is v/|v|; the first two rows
    complete a right-handed basis seeded by the world axis (x, else y)
    least aligned with v."""
    (v,) = _as_tensors(device, v)
    z = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    ex = torch.tensor([1., 0., 0.], dtype=v.dtype, device=v.device)
    ey = torch.tensor([0., 1., 0.], dtype=v.dtype, device=v.device)
    seed = torch.where((torch.abs(z[..., 0]) < 0.9)[..., None], ex, ey)
    x = seed - z * torch.sum(seed * z, dim=-1, keepdim=True)
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return torch.stack([x, torch.linalg.cross(z, x, dim=-1), z], dim=-2)
