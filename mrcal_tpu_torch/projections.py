"""Projection and unprojection through a lens model, in PyTorch:
mrcal.project / mrcal.unproject and the special-model pairs.

Counterpart of ``mrcal_tpu/projections.py``.  The functions take numpy
arrays or tensors, broadcast over leading dimensions, run on the card
unless given ``device="cpu"``, and return tensors.  Gradients come from
torch.func: forward mode for the points, reverse mode for the intrinsics
(a splined model has 1084 of them and 2 outputs).  The OPENCV and splined
models unproject by an iterative solve, and their unprojection's
gradients come from the implicit function theorem at the converged
normalized stereographic point u: with q = h(u, i) and v = g(u),
dv/dq = dv/du (dq/du)^-1 and dv/di = -dv/dq dq/di.
"""

import torch

from . import lensmodels as _lm
from .lensmodels import (parse_lensmodel, project_core,
                         stereographic_v_from_uv, unproject_core)
from .poseutils import _as_tensors, _finish, _vjac


def _normalized(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _project(v, intrinsics, lm, get_gradients):
    """project() on tensors: q, or (q, dq/dv, dq/dintrinsics)."""
    q = project_core(v, intrinsics, lm)
    if not get_gradients:
        return q

    def f(v_, i_):
        return project_core(v_, i_, lm)
    args = (v, intrinsics)
    return (q, _vjac(f, args, (1, 1), 0),
            _vjac(f, args, (1, 1), 1, torch.func.jacrev))


def _unproject(q, intrinsics, lm, normalize, get_gradients):
    """unproject() on tensors: v, or (v, dv/dq, dv/dintrinsics)."""
    v = unproject_core(q, intrinsics, lm)
    vn = _normalized(v) if normalize else v
    if not get_gradients:
        return vn
    args = (q, intrinsics)
    if lm.family in _lm._CLOSED_FORM_UNPROJECT:
        def f(q_, i_):
            v_ = unproject_core(q_, i_, lm)
            return _normalized(v_) if normalize else v_
        return (vn, _vjac(f, args, (1, 1), 0),
                _vjac(f, args, (1, 1), 1, torch.func.jacrev))

    # the iterative solve converged to u with v = g(u) = [u, 1 - |u|^2/4]
    u = v[..., :2]

    def g(u_):
        v_ = stereographic_v_from_uv(u_)
        return _normalized(v_) if normalize else v_

    def h(u_, i_):
        return project_core(stereographic_v_from_uv(u_), i_, lm)
    dv_du = _vjac(g, (u,), (1,), 0)                         # (..., 3, 2)
    dq_du = _vjac(h, (u, intrinsics), (1, 1), 0)            # (..., 2, 2)
    dq_di = _vjac(h, (u, intrinsics), (1, 1), 1, torch.func.jacrev)
    dv_dq = dv_du @ torch.linalg.inv(dq_du)
    return vn, dv_dq, -dv_dq @ dq_di


def project(v, lensmodel, intrinsics_data, *, get_gradients=False,
            out=None, device=None):
    """Project camera-frame points v (...,3) to pixels q (...,2) with
    intrinsics (...,Nintrinsics).  get_gradients: returns (q, dq_dv
    (...,2,3), dq_dintrinsics (...,2,Nintrinsics)).  Runs on the card
    unless device says otherwise."""
    lm = parse_lensmodel(lensmodel)
    v, intrinsics_data = _as_tensors(device, v, intrinsics_data)
    return _finish(_project(v, intrinsics_data, lm, get_gradients), out)


def unproject(q, lensmodel, intrinsics_data, *, normalize=False,
              get_gradients=False, out=None, device=None):
    """Unproject pixels q (...,2) to observation vectors v (...,3); unit
    vectors with normalize=True.  get_gradients: returns (v, dv_dq
    (...,3,2), dv_dintrinsics (...,3,Nintrinsics)).  Runs on the card
    unless device says otherwise."""
    lm = parse_lensmodel(lensmodel)
    q, intrinsics_data = _as_tensors(device, q, intrinsics_data)
    return _finish(_unproject(q, intrinsics_data, lm, normalize,
                              get_gradients), out)


# ----------------------------------------------------------------------------
# the special-model pairs
# ----------------------------------------------------------------------------

def _special(corefn, points, fxycxy, get_gradients, out, device):
    if fxycxy is None:
        fxycxy = [1., 1., 0., 0.]
    points, fxycxy = _as_tensors(device, points, fxycxy)
    res = corefn(points, fxycxy)
    if not get_gradients:
        return _finish(res, out)
    return _finish((res, _vjac(corefn, (points, fxycxy), (1, 1), 0)), out)


def project_pinhole(points, fxycxy=None, *, get_gradients=False, out=None,
                    device=None):
    return _special(_lm._project_pinhole_core, points, fxycxy,
                    get_gradients, out, device)


def unproject_pinhole(points, fxycxy=None, *, get_gradients=False, out=None,
                      device=None):
    return _special(_lm._unproject_pinhole_core, points, fxycxy,
                    get_gradients, out, device)


def project_stereographic(points, fxycxy=None, *, get_gradients=False,
                          out=None, device=None):
    return _special(_lm._project_stereographic_core, points, fxycxy,
                    get_gradients, out, device)


def unproject_stereographic(points, fxycxy=None, *, get_gradients=False,
                            out=None, device=None):
    return _special(_lm._unproject_stereographic_core, points, fxycxy,
                    get_gradients, out, device)


def project_lonlat(points, fxycxy=None, *, get_gradients=False, out=None,
                   device=None):
    return _special(_lm._project_lonlat_core, points, fxycxy,
                    get_gradients, out, device)


def unproject_lonlat(points, fxycxy=None, *, get_gradients=False, out=None,
                     device=None):
    return _special(_lm._unproject_lonlat_core, points, fxycxy,
                    get_gradients, out, device)


def project_latlon(points, fxycxy=None, *, get_gradients=False, out=None,
                   device=None):
    return _special(_lm._project_latlon_core, points, fxycxy,
                    get_gradients, out, device)


def unproject_latlon(points, fxycxy=None, *, get_gradients=False, out=None,
                     device=None):
    return _special(_lm._unproject_latlon_core, points, fxycxy,
                    get_gradients, out, device)
