"""Lens model registry and parametric projection, in PyTorch.

Counterpart of ``mrcal_tpu/lensmodels.py``.  Intrinsics layouts are the
reference's: every model with a core is ``[fx, fy, cx, cy, <distortions>]``
and the OPENCV models keep OpenCV's order k1,k2,p1,p2[,k3[,k4,k5,k6
[,s1..s4]]].  Each projection is one function of tensors ``q = f(v,
intrinsics)`` that broadcasts over leading dimensions and is
differentiable by autograd.  ``unproject_core`` is its inverse: closed
forms for PINHOLE, STEREOGRAPHIC, LONLAT and LATLON, a fixed-length
Gauss-Newton solve for the OPENCV, CAHVOR(E) and splined models.

LENSMODEL_SPLINED_STEREOGRAPHIC_order=O_Nx=NX_Ny=NY_fov_x_deg=F is the
core plus 2*Nx*Ny B-spline control points, laid out (Ny, Nx, 2) with the
x surface interleaved with the y surface: q = (u + deltau(u)) * f + c,
u the normalized stereographic projection, deltau a uniform B-spline
surface of order 2 or 3 over the knot grid.

LENSMODEL_CAHVOR is the core plus alpha, beta (the optical axis) and r0,
r1, r2 (radial terms); LENSMODEL_CAHVORE_linearity=L adds e0, e1, e2 (the
entrance pupil's motion along the axis), a noncentral model whose
unprojection here is central, as the JAX package's is.
"""

import math
import re
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


# family -> (num_params or None if dynamic, metadata dict)
_FAMILIES = {
    "LENSMODEL_PINHOLE":       (4,  dict(has_core=True,  can_project_behind_camera=False, has_gradients=True, noncentral=False)),
    "LENSMODEL_STEREOGRAPHIC": (4,  dict(has_core=True,  can_project_behind_camera=True,  has_gradients=True, noncentral=False)),
    "LENSMODEL_LONLAT":        (4,  dict(has_core=True,  can_project_behind_camera=True,  has_gradients=True, noncentral=False)),
    "LENSMODEL_LATLON":        (4,  dict(has_core=True,  can_project_behind_camera=True,  has_gradients=True, noncentral=False)),
    "LENSMODEL_OPENCV4":       (8,  dict(has_core=True,  can_project_behind_camera=False, has_gradients=True, noncentral=False)),
    "LENSMODEL_OPENCV5":       (9,  dict(has_core=True,  can_project_behind_camera=False, has_gradients=True, noncentral=False)),
    "LENSMODEL_OPENCV8":       (12, dict(has_core=True,  can_project_behind_camera=False, has_gradients=True, noncentral=False)),
    "LENSMODEL_OPENCV12":      (16, dict(has_core=True,  can_project_behind_camera=False, has_gradients=True, noncentral=False)),
    "LENSMODEL_CAHVOR":        (9,  dict(has_core=True,  can_project_behind_camera=False, has_gradients=True, noncentral=False)),
    "LENSMODEL_CAHVORE":       (12, dict(has_core=True,  can_project_behind_camera=False, has_gradients=True, noncentral=True)),
    "LENSMODEL_SPLINED_STEREOGRAPHIC":
                               (None, dict(has_core=True, can_project_behind_camera=True, has_gradients=True, noncentral=False)),
}

_CONFIG_FIELDS = {
    "LENSMODEL_CAHVORE": [("linearity", float)],
    "LENSMODEL_SPLINED_STEREOGRAPHIC":
        [("order", int), ("Nx", int), ("Ny", int), ("fov_x_deg", int)],
}

@dataclass(frozen=True)
class LensModel:
    """A parsed lens model: family + configuration.  Hashable."""
    family: str
    order: Optional[int] = None
    Nx: Optional[int] = None
    Ny: Optional[int] = None
    fov_x_deg: Optional[int] = None
    linearity: Optional[float] = None

    @property
    def name(self):
        if self.family == "LENSMODEL_SPLINED_STEREOGRAPHIC":
            return (f"{self.family}_order={self.order}_Nx={self.Nx}"
                    f"_Ny={self.Ny}_fov_x_deg={self.fov_x_deg}")
        if self.family == "LENSMODEL_CAHVORE":
            return f"{self.family}_linearity={self.linearity:.2f}"
        return self.family

    @property
    def num_params(self):
        n, _ = _FAMILIES[self.family]
        if n is not None:
            return n
        return 4 + 2 * self.Nx * self.Ny

    @property
    def metadata(self):
        _, meta = _FAMILIES[self.family]
        return dict(meta)

    @property
    def segments_per_u(self):
        """Knot segments per unit of normalized stereographic u, splined
        models only: the knot grid spans fov_x_deg across Nx, less a
        margin of knots the spline order needs at the edge."""
        assert self.family == "LENSMODEL_SPLINED_STEREOGRAPHIC"
        margin = 1 if self.order == 2 else 2
        th_edge_x = self.fov_x_deg / 2.0 * math.pi / 180.0
        u_edge_x = math.tan(th_edge_x / 2.0) * 2.0
        return (self.Nx - 1 - margin) / (u_edge_x * 2.0)


def parse_lensmodel(name):
    """Parse a mrcal lens-model name string (incl. config suffix) into a
    LensModel."""
    if isinstance(name, LensModel):
        return name
    # longest known family that prefixes the name
    family = None
    for fam in sorted(_FAMILIES, key=len, reverse=True):
        if name == fam or name.startswith(fam + "_"):
            family = fam
            break
    if family is None:
        raise ValueError(f"Unknown lens model family in '{name}'")
    cfgstr = name[len(family):]
    cfg = {}
    if cfgstr:
        if not re.fullmatch(r"(?:_[A-Za-z_]+=[0-9.eE+-]+)+", cfgstr):
            raise ValueError(f"Could not parse lens model config in '{name}'")
        for kv in re.finditer(r"_?([A-Za-z_]+?)=([0-9.eE+-]+)", cfgstr):
            cfg[kv.group(1)] = kv.group(2)
    fields = _CONFIG_FIELDS.get(family, [])
    expected = {f[0] for f in fields}
    if set(cfg) != expected:
        raise ValueError(
            f"Lens model '{name}': expected config fields {sorted(expected)}, "
            f"got {sorted(cfg)}")
    kwargs = {fname: ftype(cfg[fname]) for fname, ftype in fields}
    lm = LensModel(family=family, **kwargs)
    if family == "LENSMODEL_SPLINED_STEREOGRAPHIC":
        if lm.order not in (2, 3):
            raise ValueError("spline order must be 2 or 3")
        if lm.Nx < lm.order + 1 or lm.Ny < lm.order + 1:
            raise ValueError("spline grid too small for the given order")
    return lm


def supported_lensmodels():
    """Every lens model family, configured families with a placeholder
    configuration, as mrcal.supported_lensmodels() lists them."""
    return tuple(fam + "".join(f"_{f}=..." for f, _ in
                               _CONFIG_FIELDS.get(fam, ()))
                 for fam in _FAMILIES)


def lensmodel_num_params(lensmodel):
    return parse_lensmodel(lensmodel).num_params


def lensmodel_metadata_and_config(lensmodel):
    lm = parse_lensmodel(lensmodel)
    out = lm.metadata
    for fname, _ in _CONFIG_FIELDS.get(lm.family, []):
        out[fname] = getattr(lm, fname)
    return out


# ----------------------------------------------------------------------------
# projection (v: (...,3), intrinsics: (...,Nparams) -> q: (...,2))
# ----------------------------------------------------------------------------

def _core(intrinsics):
    return (intrinsics[..., 0], intrinsics[..., 1],
            intrinsics[..., 2], intrinsics[..., 3])


def _project_pinhole_core(v, intrinsics):
    fx, fy, cx, cy = _core(intrinsics)
    iz = 1.0 / v[..., 2]
    return torch.stack([v[..., 0] * iz * fx + cx,
                        v[..., 1] * iz * fy + cy], dim=-1)


def stereographic_uv(v):
    """Normalized stereographic projection u = 2 xy/(|p|+z).  (...,3)->(...,2)."""
    mag = torch.linalg.vector_norm(v, dim=-1)
    scale = 2.0 / (mag + v[..., 2])
    return v[..., :2] * scale[..., None]


def _project_stereographic_core(v, intrinsics):
    fx, fy, cx, cy = _core(intrinsics)
    u = stereographic_uv(v)
    return torch.stack([u[..., 0] * fx + cx, u[..., 1] * fy + cy], dim=-1)


def _project_lonlat_core(v, intrinsics):
    fx, fy, cx, cy = _core(intrinsics)
    mag = torch.linalg.vector_norm(v, dim=-1)
    lon = torch.atan2(v[..., 0], v[..., 2])
    lat = torch.asin(v[..., 1] / mag)
    return torch.stack([lon * fx + cx, lat * fy + cy], dim=-1)


def _project_latlon_core(v, intrinsics):
    fx, fy, cx, cy = _core(intrinsics)
    mag = torch.linalg.vector_norm(v, dim=-1)
    lat = torch.asin(v[..., 0] / mag)
    lon = torch.atan2(v[..., 1], v[..., 2])
    return torch.stack([lat * fx + cx, lon * fy + cy], dim=-1)


def _project_opencv_core(v, intrinsics, nparams):
    """OpenCV projectPoints distortion model.  Distortion order after the
    core: k1,k2,p1,p2[,k3[,k4,k5,k6[,s1,s2,s3,s4]]]."""
    fx, fy, cx, cy = _core(intrinsics)
    d = intrinsics[..., 4:]
    z = v[..., 2]
    x = v[..., 0] / z
    y = v[..., 1] / z
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2

    k1 = d[..., 0]
    k2 = d[..., 1]
    p1 = d[..., 2]
    p2 = d[..., 3]
    num = 1.0 + k1 * r2 + k2 * r4
    den = torch.ones_like(r2)
    if nparams >= 9:
        num = num + d[..., 4] * r6                       # k3
    if nparams >= 12:
        den = den + d[..., 5] * r2 + d[..., 6] * r4 + d[..., 7] * r6
    radial = num / den
    xy = x * y
    xd = x * radial + 2.0 * p1 * xy + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * xy
    if nparams >= 16:                                     # thin prism s1..s4
        xd = xd + d[..., 8] * r2 + d[..., 9] * r4
        yd = yd + d[..., 10] * r2 + d[..., 11] * r4
    return torch.stack([xd * fx + cx, yd * fy + cy], dim=-1)


# Newton iterations of CAHVORE's off-axis angle: a fixed count, the JAX
# package's (it converges in ~3)
CAHVORE_NEWTON_ITERATIONS = 20


def _project_cahvor_core(v, intrinsics, linearity=None):
    """CAHVOR, and CAHVORE when linearity is not None.  Distortions after
    the core: alpha, beta, r0, r1, r2 [, e0, e1, e2]; the optical axis o
    = (sin alpha cos beta, sin beta, cos alpha cos beta).  CAHVOR moves
    the point off the axis by mu = r0 + r1 tau + r2 tau^2, tau = |p|^2 /
    (p.o)^2 - 1.  CAHVORE solves for the off-axis angle theta of the ray
    through the moving entrance pupil by Newton's method from atan2(l,
    zeta), warps it by the linearity (chi = sin(L theta)/L, tan(L theta)/L
    or theta) and scales the off-axis part by mu + 1, mu = r0 + r1 chi^2 +
    r2 chi^4; a point within 1e-8 of the axis passes unchanged.  Then the
    pinhole projection."""
    alpha = intrinsics[..., 4]
    beta = intrinsics[..., 5]
    r0 = intrinsics[..., 6]
    r1 = intrinsics[..., 7]
    r2 = intrinsics[..., 8]
    cb = torch.cos(beta)
    o = torch.stack([torch.sin(alpha) * cb, torch.sin(beta),
                     torch.cos(alpha) * cb], dim=-1)
    if linearity is None:
        omega = torch.sum(v * o, dim=-1)
        tau = torch.sum(v * v, dim=-1) / (omega * omega) - 1.0
        mu = r0 + tau * (r1 + tau * r2)
        p_dist = v + mu[..., None] * (v - omega[..., None] * o)
        return _project_pinhole_core(p_dist, intrinsics)

    e0 = intrinsics[..., 9]
    e1 = intrinsics[..., 10]
    e2 = intrinsics[..., 11]
    zeta = torch.sum(v * o, dim=-1)
    ll = v - zeta[..., None] * o
    l = torch.linalg.vector_norm(ll, dim=-1)
    theta = torch.atan2(l, zeta)
    for _ in range(CAHVORE_NEWTON_ITERATIONS):
        sth = torch.sin(theta)
        cth = torch.cos(theta)
        th2 = theta * theta
        th3 = theta * th2
        th4 = theta * th3
        upsilon = (zeta * cth + l * sth
                   + (cth - 1.0) * (e0 + e1 * th2 + e2 * th4)
                   - (theta - sth) * (2.0 * e1 * theta + 4.0 * e2 * th3))
        theta = theta - (zeta * sth - l * cth
                         - (theta - sth) * (e0 + e1 * th2 + e2 * th4)
                         ) / upsilon
    if linearity < -1e-15:
        chi = torch.sin(theta * linearity) / linearity
    elif linearity > 1e-15:
        chi = torch.tan(theta * linearity) / linearity
    else:
        chi = theta
    chi2 = chi * chi
    chi_safe = torch.where(torch.abs(chi) < 1e-12, 1.0, chi)
    mu = r0 + r1 * chi2 + r2 * chi2 * chi2
    p_dist = (l / chi_safe)[..., None] * o + (mu + 1.0)[..., None] * ll
    p_dist = torch.where((theta > 1e-8)[..., None], p_dist, v)
    return _project_pinhole_core(p_dist, intrinsics)


# --- splined stereographic ---------------------------------------------------

def knots_for_splined_models(lensmodel, dtype=torch.float64, device=None):
    """(ux, uy): the knot locations of a splined model in normalized
    stereographic coordinates, (Nx,) and (Ny,)."""
    lm = parse_lensmodel(lensmodel)
    if lm.family != "LENSMODEL_SPLINED_STEREOGRAPHIC":
        raise ValueError("knots_for_splined_models requires a "
                         "LENSMODEL_SPLINED_STEREOGRAPHIC model")
    spu = lm.segments_per_u
    ux = (torch.arange(lm.Nx, dtype=dtype, device=device)
          - (lm.Nx - 1) / 2.0) / spu
    uy = (torch.arange(lm.Ny, dtype=dtype, device=device)
          - (lm.Ny - 1) / 2.0) / spu
    return ux, uy


def _bspline_weights_cubic(t):
    """Uniform cubic B-spline basis of t in [0,1] -> (..., 4)."""
    t2 = t * t
    t3 = t2 * t
    A = (-t3 + 3 * t2 - 3 * t + 1) / 6.0
    B = (3 * t3 / 2 - 3 * t2 + 2) / 3.0
    C = (-3 * t3 + 3 * t2 + 3 * t + 1) / 6.0
    D = t3 / 6.0
    return torch.stack([A, B, C, D], dim=-1)


def _bspline_weights_quadratic(t):
    """Uniform quadratic B-spline basis of t in [-1/2,1/2] -> (..., 3)."""
    t2 = t * t
    A = (4 * t2 - 4 * t + 1) / 8.0
    B = (3 - 4 * t2) / 4.0
    C = (4 * t2 + 4 * t + 1) / 8.0
    return torch.stack([A, B, C], dim=-1)


def bspline_weights(t, lm):
    """The spline basis of the model's order at local coordinates t."""
    return (_bspline_weights_cubic(t) if lm.order == 3
            else _bspline_weights_quadratic(t))


def splined_window_index(u, lm):
    """The spline window of normalized stereographic points u (..., 2):
    (ix0, iy0, tx, ty), the window origin as int64, clipped to [1, N-3]
    (order 3) or [1, N-2] (order 2), and the local coordinates.  Points
    off the grid keep the edge window and extrapolate (t outside the
    basis's interval).  The origin carries no gradient; tx and ty do."""
    spu = lm.segments_per_u
    ix = u[..., 0] * spu + (lm.Nx - 1) / 2.0
    iy = u[..., 1] * spu + (lm.Ny - 1) / 2.0
    if lm.order == 3:
        ix0 = torch.clamp(torch.floor(ix.detach()).to(torch.int64),
                          1, lm.Nx - 3)
        iy0 = torch.clamp(torch.floor(iy.detach()).to(torch.int64),
                          1, lm.Ny - 3)
    else:
        ix0 = torch.clamp(torch.floor(ix.detach() + 0.5).to(torch.int64),
                          1, lm.Nx - 2)
        iy0 = torch.clamp(torch.floor(iy.detach() + 0.5).to(torch.int64),
                          1, lm.Ny - 2)
    return ix0, iy0, ix - ix0, iy - iy0


def _gather_window_batched(coeffs, iyw, ixw):
    """coeffs (..., Ny, Nx, 2) whose leading dimensions broadcast to those
    of the windows' (..., R) rows iyw and columns ixw -> (..., R, R, 2).
    Indexes the leading dimensions in place (no broadcast copy of the
    coefficients)."""
    nb = iyw.dim() - 1
    lead = coeffs.shape[:-3]
    coeffs = coeffs.reshape((1,) * (nb - len(lead)) + coeffs.shape)
    idx = []
    for d in range(nb):
        shape = [1] * (nb + 2)
        shape[d] = coeffs.shape[d]
        idx.append(torch.arange(coeffs.shape[d],
                                device=iyw.device).reshape(shape))
    return coeffs[tuple(idx) + (iyw[..., :, None], ixw[..., None, :])]


def splined_deltau(u, coeffs, lm):
    """The spline correction deltau(u) -> (..., 2).  u: (..., 2)
    normalized stereographic coordinates; coeffs: (Ny, Nx, 2) control
    points (x surface [..., 0]), or (..., Ny, Nx, 2) with leading
    dimensions that broadcast against u's.  A gather of the (order+1)^2
    window and its weighted sum; autograd through the gather gives the
    window's gradient."""
    ix0, iy0, tx, ty = splined_window_index(u, lm)
    R = lm.order + 1
    wx = bspline_weights(tx, lm)                          # (..., R)
    wy = bspline_weights(ty, lm)
    offs = torch.arange(R, device=u.device)
    ixw = ix0[..., None] - 1 + offs                       # (..., R)
    iyw = iy0[..., None] - 1 + offs
    if coeffs.dim() == 3:
        window = coeffs[iyw[..., :, None], ixw[..., None, :], :]
    else:
        bshape = tuple(np.broadcast_shapes(u.shape[:-1], coeffs.shape[:-3]))
        window = _gather_window_batched(coeffs, iyw.expand(bshape + (R,)),
                                        ixw.expand(bshape + (R,)))
    return torch.einsum("...i,...j,...ijk->...k", wy, wx, window)


def _project_splined_core(v, intrinsics, lm):
    fx, fy, cx, cy = _core(intrinsics)
    u = stereographic_uv(v)
    coeffs = intrinsics[..., 4:].reshape(intrinsics.shape[:-1]
                                         + (lm.Ny, lm.Nx, 2))
    du = splined_deltau(u, coeffs, lm)
    return torch.stack([(u[..., 0] + du[..., 0]) * fx + cx,
                        (u[..., 1] + du[..., 1]) * fy + cy], dim=-1)


def project_core(v, intrinsics, lensmodel):
    """q = project(v).  v: (...,3), intrinsics: (...,Nparams) -> q: (...,2).
    Family dispatch is on the (python) lens model."""
    lm = parse_lensmodel(lensmodel)
    fam = lm.family
    if fam == "LENSMODEL_SPLINED_STEREOGRAPHIC":
        return _project_splined_core(v, intrinsics, lm)
    if fam == "LENSMODEL_CAHVOR":
        return _project_cahvor_core(v, intrinsics)
    if fam == "LENSMODEL_CAHVORE":
        return _project_cahvor_core(v, intrinsics, lm.linearity)
    if fam == "LENSMODEL_PINHOLE":
        return _project_pinhole_core(v, intrinsics)
    if fam == "LENSMODEL_STEREOGRAPHIC":
        return _project_stereographic_core(v, intrinsics)
    if fam == "LENSMODEL_LONLAT":
        return _project_lonlat_core(v, intrinsics)
    if fam == "LENSMODEL_LATLON":
        return _project_latlon_core(v, intrinsics)
    return _project_opencv_core(v, intrinsics, lm.num_params)


# ----------------------------------------------------------------------------
# unprojection (q: (...,2), intrinsics: (...,Nparams) -> v: (...,3))
# ----------------------------------------------------------------------------

def stereographic_v_from_uv(u):
    """Inverse of stereographic_uv, returning a non-unit vector
    [u, 1 - |u|^2/4]."""
    norm2u = torch.sum(u * u, dim=-1)
    return torch.cat([u, (1.0 - norm2u / 4.0)[..., None]], dim=-1)


def _unproject_pinhole_core(q, intrinsics):
    fx, fy, cx, cy = _core(intrinsics)
    x = (q[..., 0] - cx) / fx
    return torch.stack([x, (q[..., 1] - cy) / fy, torch.ones_like(x)],
                       dim=-1)


def _unproject_stereographic_core(q, intrinsics):
    fx, fy, cx, cy = _core(intrinsics)
    u = torch.stack([(q[..., 0] - cx) / fx, (q[..., 1] - cy) / fy], dim=-1)
    return stereographic_v_from_uv(u)


def _unproject_lonlat_core(q, intrinsics):
    fx, fy, cx, cy = _core(intrinsics)
    lon = (q[..., 0] - cx) / fx
    lat = (q[..., 1] - cy) / fy
    clat = torch.cos(lat)
    return torch.stack([clat * torch.sin(lon), torch.sin(lat),
                        clat * torch.cos(lon)], dim=-1)


def _unproject_latlon_core(q, intrinsics):
    fx, fy, cx, cy = _core(intrinsics)
    lat = (q[..., 0] - cx) / fx
    lon = (q[..., 1] - cy) / fy
    clat = torch.cos(lat)
    return torch.stack([torch.sin(lat), clat * torch.sin(lon),
                        clat * torch.cos(lon)], dim=-1)


_CLOSED_FORM_UNPROJECT = {
    "LENSMODEL_PINHOLE": _unproject_pinhole_core,
    "LENSMODEL_STEREOGRAPHIC": _unproject_stereographic_core,
    "LENSMODEL_LONLAT": _unproject_lonlat_core,
    "LENSMODEL_LATLON": _unproject_latlon_core,
}


# Gauss-Newton iterations of the unprojection of the models without a
# closed form: a fixed count, the JAX package's default
UNPROJECT_ITERATIONS = 25


def unproject_core(q, intrinsics, lensmodel,
                   iterations=UNPROJECT_ITERATIONS):
    """v = unproject(q).  q: (...,2), intrinsics: (...,Nparams) -> (...,3).

    The closed-form models keep the reference's non-unit conventions
    (PINHOLE: v_z = 1) and ignore `iterations`.  The OPENCV, CAHVOR(E) and
    splined models solve project(v(u)) = q for u
    in normalized stereographic coordinates by Gauss-Newton, starting from
    the stereographic guess with the same core, for `iterations` steps,
    with the 2x2 normal equations solved by Cramer's rule.
    Every point iterates at once; the rows of its 2x2 Jacobian come from
    two reverse-mode products (two cotangents), so the result carries no
    autograd graph."""
    lm = parse_lensmodel(lensmodel)
    if lm.family in _CLOSED_FORM_UNPROJECT:
        return _CLOSED_FORM_UNPROJECT[lm.family](q, intrinsics)

    bshape = torch.Size(np.broadcast_shapes(q.shape[:-1],
                                            intrinsics.shape[:-1]))
    qb = q.detach().expand(bshape + (2,)).reshape(-1, 2)
    ib = intrinsics.detach().expand(bshape + intrinsics.shape[-1:]).reshape(
        -1, intrinsics.shape[-1])
    u = torch.stack([(qb[:, 0] - ib[:, 2]) / ib[:, 0],
                     (qb[:, 1] - ib[:, 3]) / ib[:, 1]], dim=-1)
    for _ in range(iterations):
        with torch.enable_grad():
            uu = u.requires_grad_(True)
            q_u = project_core(stereographic_v_from_uv(uu), ib, lm)
            # row m of J = dq_m/du
            J0, = torch.autograd.grad(q_u[:, 0], uu, torch.ones_like(qb[:, 0]),
                                      retain_graph=True)
            J1, = torch.autograd.grad(q_u[:, 1], uu, torch.ones_like(qb[:, 1]))
        r = q_u.detach() - qb
        # J^T J + 1e-12 I and J^T r
        A00 = J0[:, 0] * J0[:, 0] + J1[:, 0] * J1[:, 0] + 1e-12
        A01 = J0[:, 0] * J0[:, 1] + J1[:, 0] * J1[:, 1]
        A11 = J0[:, 1] * J0[:, 1] + J1[:, 1] * J1[:, 1] + 1e-12
        g0 = J0[:, 0] * r[:, 0] + J1[:, 0] * r[:, 1]
        g1 = J0[:, 1] * r[:, 0] + J1[:, 1] * r[:, 1]
        det = A00 * A11 - A01 * A01
        u = u.detach() - torch.stack([A11 * g0 - A01 * g1,
                                      A00 * g1 - A01 * g0],
                                     dim=-1) / det[:, None]
    return stereographic_v_from_uv(u).reshape(bshape + (3,))
