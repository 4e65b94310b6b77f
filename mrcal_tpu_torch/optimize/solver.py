"""Trust-region Levenberg-Marquardt with Schur-complement block elimination.

Counterpart of ``mrcal_tpu/optimize/solver.py`` for parametric and
splined models:

  - per-corner (boards), per-observation (points) and per-pair
    (triangulated points) Jacobian rows from autograd, one cotangent per
    output component; the global Jacobian is never formed
  - normal equations assembled with batched einsum and ``index_add_``;
    splined boards with the core locked take the spline-window assembly
    instead: each corner row holds its (order+1)^2-knot window, a
    closed-form Jacobian, written into dense camera-system rows with
    ``index_put_`` and multiplied out (H = rows^T rows), optionally in
    float32 under a float64 gradient
  - frame (6x6) and point (3x3) blocks eliminated with the batched
    Cholesky kernel (factored once per step, solved three times), the
    reduced camera system solved densely, in the H blocks' dtype
  - the gain-ratio LM control of the JAX package's device loop, as one
    Python loop with tensors on the device and one scalar read per
    iteration, with the lazy-Hessian mode (H refreshed every K+1-th
    accepted step, E and g exact on every one)
  - the outlier-rejection loop (boards and triangulated pairs), the
    precision modes, the write-back and the check_gradient mode of
    ``optimize()``
"""

import time
import warnings
from contextlib import contextmanager

import numpy as np
import torch

from .._config import DEFAULT_DTYPE, resolve_device
from ..lensmodels import (bspline_weights, project_core, require_ported,
                          splined_window_index, stereographic_uv)
from ..ops.batched_cholesky import (cholesky_factor_solve,
                                   cholesky_solve_factored)
from ..poseutils import _compose_rt2, _transform_point_rt
from ..triangulation import _leecivera_mid2, _triangulated_error
from . import layout as _layout
from .layout import ProblemSpec, spec_from_inputs, triangulated_pair_indices
from .residuals import (arrays_from_inputs, params_from_arrays,
                        distortion_regularization_scales,
                        knot_direction_weights, pack_params,
                        residuals_from_packed, split_packed_state,
                        splined_regularization, triangulated_pair_geometry)

# relative LM damping floor: keeps the near-gauge-direction step from
# blowing up into a lambda limit cycle at convergence
_LAM_FLOOR = 1e-11
# effective damping floor of f32 normal equations: their diagonal carries
# ~eps32 relative noise, and H + lam*diag(H) goes indefinite below this
_F32_LAM_FLOOR = 4e-7

_NOT_PORTED_OPTIONS = {
    "mesh": "ROADMAP queue 1 item 11 (multi-GPU)",
    "verbose": "ROADMAP queue 1 item 7 (verbose per-iteration output)",
}


# ----------------------------------------------------------------------------
# camera-system ("c") layout: [intrinsics-state | extrinsics | warp], packed
# ----------------------------------------------------------------------------

class _CLayout:
    def __init__(self, spec: ProblemSpec):
        self.Nip = spec.Nintrinsics_state_per_cam
        self.Nci = spec.Ncameras_intrinsics
        self.Nce = spec.Ncameras_extrinsics
        self.i0 = 0
        self.e0 = self.Nip * self.Nci
        self.w0 = self.e0 + 6 * self.Nce
        self.Nc = self.w0 + 2  # warp slots always allocated (zero if unused)

    def coli(self, ci):
        return self.i0 + ci * self.Nip

    def cole(self, ce):
        return self.e0 + 6 * ce


def _intr_scales(spec: ProblemSpec):
    """packing scales for the per-camera intrinsics STATE block."""
    s = []
    if spec.Ncore_state:
        s += [_layout.SCALE_INTRINSICS_FOCAL_LENGTH] * 2
        s += [_layout.SCALE_INTRINSICS_CENTER_PIXEL] * 2
    if spec.selections.do_optimize_intrinsics_distortions:
        s += [_layout.SCALE_DISTORTION] * spec.Ndistortions
    return np.asarray(s, dtype=np.float64)


_EXT_SCALES = np.array([_layout.SCALE_ROTATION_CAMERA] * 3 +
                       [_layout.SCALE_TRANSLATION_CAMERA] * 3)
_FRAME_SCALES = np.array([_layout.SCALE_ROTATION_FRAME] * 3 +
                         [_layout.SCALE_TRANSLATION_FRAME] * 3)
_WARP_SCALES = np.array([_layout.SCALE_CALOBJECT_WARP] * 2)
_POINT_SCALES = np.array([_layout.SCALE_POSITION_POINT] * 3)


class _Consts:
    """The packing scales and regularization constants of one problem as
    tensors of one dtype on one device, made once per solve so that the
    iterations copy nothing from the host."""

    def __init__(self, spec: ProblemSpec, dtype, device):
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                   device=device)
        self.state = t(spec.scales())
        self.intr = t(_intr_scales(spec))
        self.ext = t(_EXT_SCALES)
        self.frame = t(_FRAME_SCALES)
        self.warp = t(_WARP_SCALES)
        self.point = t(_POINT_SCALES)
        self.reg_dist = t(distortion_regularization_scales(spec))
        if spec.is_splined:
            self.reg_knots = tuple(t(a) for a in knot_direction_weights(spec))
        self.reg_targets = t([[(w - 1) * 0.5, (h - 1) * 0.5]
                              for w, h in spec.imagersizes]
                             or np.zeros((spec.Ncameras_intrinsics, 2)))


def _merge_intrinsics(intr_state, intr_fixed, spec, iscales):
    """Combine the packed per-camera intrinsics state block with the fixed
    (non-optimized) parts into a full intrinsics vector (real units)."""
    full = intr_fixed
    if spec.Nintrinsics_state_per_cam == 0:
        return full
    st = intr_state * iscales
    j = 0
    if spec.Ncore_state:
        full = torch.cat([st[..., :4], full[..., 4:]], dim=-1)
        j = 4
    if spec.selections.do_optimize_intrinsics_distortions:
        full = torch.cat([full[..., :spec.Ncore], st[..., j:]], dim=-1)
    return full


# ----------------------------------------------------------------------------
# per-corner / per-observation residual functions (packed blocks -> rows)
# ----------------------------------------------------------------------------

def _board_corners_cam(spec: ProblemSpec, consts, blocks, cxy, warp_fixed):
    """A flat batch of board corners in camera coordinates (N, 3), from
    each corner's packed ext, frame and warp blocks (N, n) and its grid
    indices cxy (N, 2) (x, y) as floats."""
    H = spec.calibration_object_height_n
    W = spec.calibration_object_width_n
    sp = spec.calibration_object_spacing
    rt_cam = blocks["ext"] * consts.ext
    rt_frame = blocks["frame"] * consts.frame
    if spec.has_calobject_warp:
        warp = blocks["warp"] * consts.warp
    else:
        warp = warp_fixed.expand(cxy.shape[0], 2)
    rt_joint = _compose_rt2(rt_cam, rt_frame)
    xr = cxy[:, 0] / (W - 1)
    yr = cxy[:, 1] / (H - 1)
    z = (warp[:, 0] * 4.0 * xr * (1.0 - xr) +
         warp[:, 1] * 4.0 * yr * (1.0 - yr))
    pt = torch.stack([cxy[:, 0] * sp, cxy[:, 1] * sp, z], dim=-1)
    return _transform_point_rt(rt_joint, pt)


def _make_board_corner_fn(spec: ProblemSpec, consts):
    """Board residual of a flat batch of corners: (blocks, corner grid xy,
    observed corners) -> (N, 2).  Each corner has its own copy of the
    packed blocks, so one backward pass per output component gives every
    corner's Jacobian row at once."""

    def fn(blocks, cxy, obs_c, intr_fixed, warp_fixed):
        # blocks: dict(intr (N,Nip), ext (N,6), frame (N,6), warp (N,2))
        # cxy: (N,2) grid indices (x, y) as floats; obs_c: (N,3) x,y,weight
        intr = _merge_intrinsics(blocks["intr"], intr_fixed, spec,
                                 consts.intr)
        p_cam = _board_corners_cam(spec, consts, blocks, cxy, warp_fixed)
        q = project_core(p_cam, intr, spec.lensmodel)
        w = torch.clamp_min(obs_c[:, 2], 0.0)
        return (q - obs_c[:, :2]) * w[:, None]                 # (N,2)

    return fn


def _make_splined_corner_fn(spec: ProblemSpec, consts):
    """Board residual of a flat batch of corners of a splined model with
    the core locked, as a function of the pose blocks alone: (blocks,
    corner grid xy, observed corners, core (N, 4), control points
    (Nci, Ny, Nx, 2), cameras (N,)) -> (N, 2), and as aux the window
    origins (ix0, iy0) and the basis weights (wx, wy) (N, R), without
    gradient.  The window origin carries no gradient; the local
    coordinates within it carry the pose's."""
    lm = spec.lensmodel
    R = lm.order + 1

    def fn(blocks, cxy, obs_c, core4, coeffs, ici_c, warp_fixed):
        p_cam = _board_corners_cam(spec, consts, blocks, cxy, warp_fixed)
        u = stereographic_uv(p_cam)
        ix0, iy0, tx, ty = splined_window_index(u, lm)
        offs = torch.arange(R, device=u.device)
        win = coeffs[ici_c[:, None, None],
                     (iy0[:, None] - 1 + offs)[:, :, None],
                     (ix0[:, None] - 1 + offs)[:, None, :]]   # (N,R,R,2)
        wx = bspline_weights(tx, lm)
        wy = bspline_weights(ty, lm)
        du = torch.einsum("ni,nj,nijk->nk", wy, wx, win)
        q = (u + du) * core4[:, :2] + core4[:, 2:4]
        w = torch.clamp_min(obs_c[:, 2], 0.0)
        return ((q - obs_c[:, :2]) * w[:, None],
                (ix0, iy0, wx.detach(), wy.detach()))

    return fn


def _make_point_fn(spec: ProblemSpec, consts):
    def fn(blocks, obs, intr_fixed):
        # blocks: dict(intr (N,Nip), ext (N,6), point (N,3)) packed
        intr = _merge_intrinsics(blocks["intr"], intr_fixed, spec,
                                 consts.intr)
        rt_cam = blocks["ext"] * consts.ext
        p_ref = blocks["point"] * consts.point
        p_cam = _transform_point_rt(rt_cam, p_ref)
        q = project_core(p_cam, intr, spec.lensmodel)
        w = torch.where(obs[:, 2] > 0.0, obs[:, 2], 0.0)
        return (q - obs[:, :2]) * w[:, None]                   # (N,2)

    return fn


def _make_tri_fn(consts):
    """Ray divergence of a flat batch of observation pairs: (blocks, v0,
    v1) -> (N, 1), blocks = dict(rt0, rt1) the two cameras' packed
    rt_cam_ref, one copy per pair."""
    def fn(blocks, v0, v1):
        v0_cam1, t_10 = triangulated_pair_geometry(
            blocks["rt0"] * consts.ext, blocks["rt1"] * consts.ext, v0)
        return _triangulated_error(v1, v0_cam1, t_10)[:, None]

    return fn


def _corner_grid(spec: ProblemSpec, Nobs, dtype, device):
    """The board grid indices (x, y) of every corner of Nobs observations,
    observation-major, then row-major over the board -> (Nobs*H*W, 2)."""
    xg, yg = np.meshgrid(
        np.arange(spec.calibration_object_width_n, dtype=np.float64),
        np.arange(spec.calibration_object_height_n, dtype=np.float64))
    cxy = np.stack([xg, yg], axis=-1).reshape(-1, 2)
    return torch.as_tensor(np.tile(cxy, (Nobs, 1)), dtype=dtype,
                           device=device)


def _rows_and_jacobian(fn, blocks, *args, has_aux=False):
    """r = fn(blocks, *args) of shape (N, 2) where row i depends only on
    row i of every block, and its Jacobian {k: (N, 2, n_k)}: one backward
    pass per output component (two cotangents).  has_aux: fn returns (r,
    aux), and this returns (r, J, aux)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in blocks.items()}
    names = list(leaves)
    with torch.enable_grad():
        r = fn(leaves, *args)
        if has_aux:
            r, aux = r
        rows = []
        for m in range(r.shape[1]):
            g = torch.autograd.grad(
                r[:, m], [leaves[k] for k in names],
                grad_outputs=torch.ones_like(r[:, m]),
                retain_graph=m + 1 < r.shape[1], allow_unused=True)
            rows.append([gk if gk is not None else torch.zeros_like(leaves[k])
                         for k, gk in zip(names, g)])
    J = {k: torch.stack([rows[m][i] for m in range(len(rows))], dim=1)
         for i, k in enumerate(names)}
    if has_aux:
        return r.detach(), J, aux
    return r.detach(), J


def _rows_and_vjp(fn, blocks, *args):
    """(r, aux) = fn(blocks, *args) as in _rows_and_jacobian, and
    J_i^T r_i per row i {k: (N, n_k)}, from one backward pass with r as
    its cotangent: the gradient without the Jacobian."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in blocks.items()}
    names = list(leaves)
    with torch.enable_grad():
        r, aux = fn(leaves, *args)
        g = torch.autograd.grad(r, [leaves[k] for k in names],
                                grad_outputs=r.detach(), allow_unused=True)
    return r.detach(), {k: gk if gk is not None
                        else torch.zeros_like(leaves[k])
                        for k, gk in zip(names, g)}, aux


class _ObservationRows:
    """The residual rows of each kind of observation and their Jacobians
    over the observation's own packed blocks, for one problem, on the
    device and in the dtype of `arrays`: board rows per corner, point rows
    per observation, triangulated rows per pair.  The normal equations and
    the sparse Jacobian both take their rows from here."""

    def __init__(self, spec: ProblemSpec, arrays):
        dt = arrays["intrinsics"].dtype
        dev = arrays["intrinsics"].device
        self.spec = spec
        self.consts = _Consts(spec, dt, dev)
        if spec.Nobservations_board:
            self.board_fn = _make_board_corner_fn(spec, self.consts)
            if spec.is_splined:
                self.splined_fn = _make_splined_corner_fn(spec, self.consts)
            self.HW = spec.calibration_object_height_n * \
                spec.calibration_object_width_n
            self.cxy = _corner_grid(spec, spec.Nobservations_board, dt, dev)
        if spec.Nobservations_point:
            self.point_fn = _make_point_fn(spec, self.consts)
        if spec.num_measurements_points_triangulated:
            self.tri_fn = _make_tri_fn(self.consts)
            self.i0, self.i1 = (
                torch.as_tensor(a, device=dev) for a in
                triangulated_pair_indices(spec.triangulated_set_sizes))
            ice = arrays["indices_triangulated"][:, 2]
            # the pairs' cameras, as rows of the padded extrinsics
            self.ie0, self.ie1 = ice[self.i0] + 1, ice[self.i1] + 1

    def packed(self, params):
        """The packed blocks of a parameter dict in real units: the
        intrinsics state (Nci, Nip), the full intrinsics (real units), the
        extrinsics with an identity row first for the camera at the
        reference (Nce + 1, 6), the frames, points and warp."""
        s, c = self.spec.selections, self.consts
        intr_full = params["intrinsics"]
        cols = []
        if self.spec.Ncore_state:
            cols.append(intr_full[:, :4])
        if s.do_optimize_intrinsics_distortions:
            cols.append(intr_full[:, self.spec.Ncore:])
        ext = params["extrinsics"] / c.ext
        return dict(
            intr=(torch.cat(cols, dim=-1) / c.intr if cols
                  else intr_full[:, :0]),
            intr_full=intr_full,
            ext=ext,
            ext_pad=torch.cat([ext.new_zeros((1, 6)), ext], dim=0),
            frame=params["frames"] / c.frame,
            point=params["points"] / c.point,
            warp=params["calobject_warp"] / c.warp,
            warp_real=params["calobject_warp"])

    def board(self, pk, arrays):
        """-> r (Nobs*H*W, 2) and J {intr, ext, frame, warp: (Nobs*H*W, 2,
        n)}.  Every corner gets its own copy of its observation's blocks."""
        idx = arrays["indices_board"]
        ifr, ici, ice = idx[:, 0], idx[:, 1], idx[:, 2]
        blocks = dict(intr=pk["intr"][ici], ext=pk["ext_pad"][ice + 1],
                      frame=pk["frame"][ifr],
                      warp=pk["warp"].expand(len(idx), 2))
        return _rows_and_jacobian(
            self.board_fn,
            {k: v.repeat_interleave(self.HW, dim=0)
             for k, v in blocks.items()},
            self.cxy, arrays["observations_board"].reshape(-1, 3),
            pk["intr_full"][ici].repeat_interleave(self.HW, dim=0),
            pk["warp_real"])

    def splined_board(self, pk, arrays, jacobian=True):
        """The board rows of a splined model with the core locked, per
        corner: r (N, 2), the pose Jacobian {ext, frame, warp: (N, 2,
        n)}, the window Jacobian Jw (N, 2, 2R^2) over the window's control
        points, their columns in the camera-system layout wincols (N,
        2R^2), and the windows' (ix0, iy0, wx, wy).  q is linear in the
        window: dr_k/dwin[jy, jx, m] = w f_k wy[jy] wx[jx] delta_km, in
        packed units since the distortions' packing scale is 1.
        jacobian=False: J^T r per corner {ext, frame, warp: (N, n)} in
        place of the pose Jacobian, and no Jw."""
        assert _layout.SCALE_DISTORTION == 1.0
        spec = self.spec
        lm = spec.lensmodel
        R = lm.order + 1
        idx = arrays["indices_board"]
        ifr, ici, ice = idx[:, 0], idx[:, 1], idx[:, 2]
        ici_c = ici.repeat_interleave(self.HW)
        blocks = dict(ext=pk["ext_pad"][ice + 1], frame=pk["frame"][ifr],
                      warp=pk["warp"].expand(len(idx), 2))
        intr_full = pk["intr_full"]
        core4 = intr_full[ici_c, :4]
        coeffs = intr_full[:, 4:].reshape(-1, lm.Ny, lm.Nx, 2)
        obs_c = arrays["observations_board"].reshape(-1, 3)
        args = ({k: v.repeat_interleave(self.HW, dim=0)
                 for k, v in blocks.items()},
                self.cxy, obs_c, core4, coeffs, ici_c, pk["warp_real"])
        if not jacobian:
            r, JTr, aux = _rows_and_vjp(self.splined_fn, *args)
            return r, JTr, aux
        r, J, (ix0, iy0, wx, wy) = _rows_and_jacobian(
            self.splined_fn, *args, has_aux=True)
        N = r.shape[0]
        f2 = core4[:, :2] * torch.clamp_min(obs_c[:, 2], 0.0)[:, None]
        eye2 = torch.eye(2, dtype=r.dtype, device=r.device)
        Jw = (wy[:, None, :, None, None] * wx[:, None, None, :, None]
              * f2[:, :, None, None, None]
              * eye2[None, :, None, None, :]).reshape(N, 2, R * R * 2)
        offs = torch.arange(R, device=r.device)
        knot = ((iy0[:, None] - 1 + offs)[:, :, None] * lm.Nx
                + (ix0[:, None] - 1 + offs)[:, None, :])      # (N,R,R)
        wincols = (ici_c[:, None, None, None]
                   * spec.Nintrinsics_state_per_cam
                   + 2 * knot[..., None]
                   + torch.arange(2, device=r.device)).reshape(N, -1)
        return r, J, Jw, wincols, (ix0, iy0, wx, wy)

    def point(self, pk, arrays):
        """-> r (Nobs, 2) and J {intr, ext, point: (Nobs, 2, n)}; fixed
        points pass their real position / scale."""
        idx = arrays["indices_point"]
        ipt, ici, ice = idx[:, 0], idx[:, 1], idx[:, 2]
        return _rows_and_jacobian(
            self.point_fn, dict(intr=pk["intr"][ici],
                                ext=pk["ext_pad"][ice + 1],
                                point=pk["point"][ipt]),
            arrays["observations_point"], pk["intr_full"][ici])

    def tri(self, pk, arrays):
        """-> x (Npairs,) and the Jacobians over the pair's two cameras'
        packed rt blocks, J0 and J1 (Npairs, 6); 0 for a pair with an
        outlier observation."""
        px = arrays["px_triangulated"]
        w = arrays["observations_point_triangulated"][:, 2]
        r, J = _rows_and_jacobian(
            self.tri_fn, dict(rt0=pk["ext_pad"][self.ie0],
                              rt1=pk["ext_pad"][self.ie1]),
            px[self.i0], px[self.i1])
        valid = (w[self.i0] > 0) & (w[self.i1] > 0)
        # where, not multiply: an outlier pair's err/J may be NaN
        return (torch.where(valid, r[:, 0], 0.0),
                torch.where(valid[:, None], J["rt0"][:, 0], 0.0),
                torch.where(valid[:, None], J["rt1"][:, 0], 0.0))

    def regularization(self, pk):
        """The per-camera regularization rows (Nci, nterms), distortions
        then center pixel, and their Jacobians over the camera's
        intrinsics state (Nci, nterms, Nip), None without one."""
        spec, consts = self.spec, self.consts

        def reg_fn_cam(intr_state_1, intr_fixed_1, target_1):
            intr1 = _merge_intrinsics(intr_state_1, intr_fixed_1, spec,
                                      consts.intr)
            return _reg_per_camera(intr1, spec, consts, target_1)

        args = (pk["intr"], pk["intr_full"], consts.reg_targets)
        rreg = torch.func.vmap(reg_fn_cam)(*args)
        Jreg = (torch.func.vmap(torch.func.jacrev(reg_fn_cam))(*args)
                if pk["intr"].shape[1] and rreg.shape[1] else None)
        return rreg, Jreg

    def unity_cam01(self, pk):
        """The unity_cam01 row (|t| of extrinsics 0 held at 1) and its
        Jacobian over that camera's packed rt (6,)."""
        c = 0.1 / 0.01
        t0 = pk["ext"][0, 3:] * _layout.SCALE_TRANSLATION_CAMERA
        ru = c * (torch.sum(t0 * t0) - 1.0)
        Ju = torch.cat([t0.new_zeros(3),
                        c * 2.0 * t0 * _layout.SCALE_TRANSLATION_CAMERA])
        return ru, Ju


# ----------------------------------------------------------------------------
# normal-equation assembly
# ----------------------------------------------------------------------------

def _distinct_pairs(idx_np):
    """Static list of distinct (ici, ice) pairs with observation id lists."""
    pairs = {}
    for i, (ci, ce) in enumerate(idx_np):
        pairs.setdefault((int(ci), int(ce)), []).append(i)
    return [(k, np.asarray(v)) for k, v in sorted(pairs.items())]


def _pair_ids(oids, nobs, device):
    """Device index tensor of one pair's observations; None when the pair
    holds every observation in order (no gather needed)."""
    if len(oids) == nobs and np.array_equal(oids, np.arange(nobs)):
        return None
    return torch.as_tensor(oids, dtype=torch.int64, device=device)


def _take(t, ids):
    return t if ids is None else t[ids]


def _seg(x, ids, n):
    """segment_sum: sum the rows of x into n segments by ids."""
    return x.new_zeros((n,) + x.shape[1:]).index_add_(0, ids, x)


def _reg_per_camera(intr_row, spec: ProblemSpec, consts, target):
    """Single-camera regularization residuals (distortion then
    centerpixel), same math as residuals_regularization."""
    s = spec.selections
    parts = []
    nominal_pixel_error = 0.1
    if s.do_apply_regularization and s.do_optimize_intrinsics_distortions \
            and spec.Ndistortions > 0:
        if spec.is_splined:
            lm = spec.lensmodel
            parts.append(splined_regularization(
                intr_row[4:].reshape(lm.Ny, lm.Nx, 2), *consts.reg_knots))
        else:
            parts.append(intr_row[spec.Ncore:] * consts.reg_dist)
    if s.do_apply_regularization and spec.has_core \
            and s.do_optimize_intrinsics_core:
        # the reference scales by camera 0's width for ALL cameras, but
        # targets the center of each camera
        W0 = spec.imagersizes[0][0]
        scale = nominal_pixel_error / (W0 * 0.1)
        parts.append(scale * (intr_row[2:4] - target))
    if not parts:
        return intr_row[:0]
    return torch.cat(parts)


def build_normal_equations(spec: ProblemSpec, arrays, static_idx, *,
                           h32=False):
    """Returns a function f(b, arrays) -> dict(E, g_c, g_f, g_p, Hcc, Hff,
    Cf, Hpp, Cp, x_board, x_point, x_tri, x_reg) where b is the packed
    state; H/C are the block normal-equation pieces in packed coordinates.
    static_idx carries numpy copies of the index arrays (for the static
    per-camera-pair grouping).  The constants live on the device and in the
    dtype of `arrays`.

    Splined models with the core locked take the spline-window assembly
    (build_normal_equations_splined), whose f also has a gradient-only
    mode, and which alone takes h32."""
    require_ported(spec.lensmodel)
    if _splined_fast_path_ok(spec):
        return build_normal_equations_splined(spec, arrays, static_idx,
                                              h32=h32)
    if h32:
        raise ValueError("h32: only the splined window assembly assembles "
                         "H in float32")
    s = spec.selections
    cl = _CLayout(spec)
    Nf = spec.Nframes
    Npv = spec.Npoints_variable
    dt = arrays["intrinsics"].dtype
    dev = arrays["intrinsics"].device
    rows_of = _ObservationRows(spec, arrays)
    consts = rows_of.consts

    idxb_np = np.asarray(static_idx["board"]).reshape(-1, 3)
    idxp_np = np.asarray(static_idx["point"]).reshape(-1, 3)
    Nob = len(idxb_np) if spec.Nobservations_board else 0
    Nop = len(idxp_np) if spec.Nobservations_point else 0
    pairs_b = [(k, _pair_ids(v, Nob, dev))
               for k, v in _distinct_pairs(idxb_np[:, 1:3])] if Nob else []
    pairs_p = [(k, _pair_ids(v, Nop, dev))
               for k, v in _distinct_pairs(idxp_np[:, 1:3])] if Nop else []
    idxb = torch.tensor(idxb_np, dtype=torch.int64, device=dev)
    idxp = torch.tensor(idxp_np, dtype=torch.int64, device=dev)
    if Nob:
        M = 2 * spec.calibration_object_height_n * \
            spec.calibration_object_width_n
        ext_valid_b = (idxb[:, 2] >= 0).to(dt)[:, None, None]
    if Nop:
        ext_valid_p = (idxp[:, 2] >= 0).to(dt)[:, None, None]
        point_var = (idxp[:, 0] < Npv).to(dt)[:, None, None]
        ipt_c = torch.clamp(idxp[:, 0], 0, max(Npv - 1, 0))
    Ntri = spec.num_measurements_points_triangulated
    if Ntri:
        # triangulated points are not state: each pair's row touches only
        # its two cameras' extrinsics, in the Hcc/g_c blocks
        tri_rows = torch.arange(Ntri, device=dev)
        tri_ext = bool(s.do_optimize_extrinsics and spec.Ncameras_extrinsics)

    def f(b, arrays):
        params = split_packed_state(b, arrays, spec, scales=consts.state)
        pk = rows_of.packed(params)

        Nc = cl.Nc
        zeros = b.new_zeros
        g_c = zeros(Nc)
        Hcc = zeros((Nc, Nc))
        g_f = zeros((max(Nf, 1), 6))
        Hff = zeros((max(Nf, 1), 6, 6))
        Cf = zeros((max(Nf, 1), 6, Nc))
        g_p = zeros((max(Npv, 1), 3))
        Hpp = zeros((max(Npv, 1), 3, 3))
        Cp = zeros((max(Npv, 1), 3, Nc))
        E = zeros(())
        x_board = zeros((0,))
        x_point = zeros((0,))
        w0, Nip = cl.w0, cl.Nip

        # ---------------- board observations ----------------
        if Nob:
            ifr = idxb[:, 0]
            r2, J2 = rows_of.board(pk, arrays)
            r = r2.reshape(Nob, M)
            J = {k: v.reshape(Nob, M, v.shape[-1]) for k, v in J2.items()}
            Ji = J["intr"] if Nip > 0 else torch.zeros_like(J["intr"])
            Je = J["ext"] if s.do_optimize_extrinsics \
                else torch.zeros_like(J["ext"])
            Jf = J["frame"] if s.do_optimize_frames \
                else torch.zeros_like(J["frame"])
            Jw = J["warp"] if spec.has_calobject_warp \
                else torch.zeros_like(J["warp"])
            # camera at reference: no extrinsics gradient
            Je = Je * ext_valid_b

            x_board = r.reshape(-1)
            E = E + torch.sum(r * r)

            gi = torch.einsum("omi,om->oi", Ji, r)
            ge = torch.einsum("omi,om->oi", Je, r)
            gf = torch.einsum("omi,om->oi", Jf, r)
            gw = torch.einsum("omi,om->i", Jw, r)
            g_c[w0:w0 + 2] += gw
            if Nf:
                g_f[:Nf] += _seg(gf, ifr, Nf)
                Hff[:Nf] += _seg(torch.einsum("omi,omj->oij", Jf, Jf),
                                 ifr, Nf)
            # warp self + warp-frame cross
            Hcc[w0:w0 + 2, w0:w0 + 2] += torch.einsum("omi,omj->ij", Jw, Jw)
            if Nf:
                Cf[:, :, w0:w0 + 2] += _seg(
                    torch.einsum("omi,omj->oij", Jf, Jw), ifr, Nf)

            # per distinct (ici,ice) pair: static column placement
            for (ci, ce), oid in pairs_b:
                Ji_p, Je_p, Jf_p, Jw_p = (_take(Ji, oid), _take(Je, oid),
                                          _take(Jf, oid), _take(Jw, oid))
                ifr_p = _take(ifr, oid)
                i0 = cl.coli(ci)
                g_c[i0:i0 + Nip] += torch.sum(_take(gi, oid), dim=0)
                Hcc[i0:i0 + Nip, i0:i0 + Nip] += \
                    torch.einsum("omi,omj->ij", Ji_p, Ji_p)
                # intr-warp cross
                Hiw = torch.einsum("omi,omj->ij", Ji_p, Jw_p)
                Hcc[i0:i0 + Nip, w0:w0 + 2] += Hiw
                Hcc[w0:w0 + 2, i0:i0 + Nip] += Hiw.T
                if Nf:
                    Cf[:, :, i0:i0 + Nip] += _seg(
                        torch.einsum("omi,omj->oij", Jf_p, Ji_p), ifr_p, Nf)
                if ce >= 0:
                    e0 = cl.cole(ce)
                    g_c[e0:e0 + 6] += torch.sum(_take(ge, oid), dim=0)
                    Hcc[e0:e0 + 6, e0:e0 + 6] += \
                        torch.einsum("omi,omj->ij", Je_p, Je_p)
                    Hie = torch.einsum("omi,omj->ij", Ji_p, Je_p)
                    Hcc[i0:i0 + Nip, e0:e0 + 6] += Hie
                    Hcc[e0:e0 + 6, i0:i0 + Nip] += Hie.T
                    Hew = torch.einsum("omi,omj->ij", Je_p, Jw_p)
                    Hcc[e0:e0 + 6, w0:w0 + 2] += Hew
                    Hcc[w0:w0 + 2, e0:e0 + 6] += Hew.T
                    if Nf:
                        Cf[:, :, e0:e0 + 6] += _seg(
                            torch.einsum("omi,omj->oij", Jf_p, Je_p),
                            ifr_p, Nf)

        # ---------------- point observations ----------------
        if Nop:
            r, J = rows_of.point(pk, arrays)                   # (Nop,2)
            Ji = J["intr"] if Nip > 0 else torch.zeros_like(J["intr"])
            Je = J["ext"] if s.do_optimize_extrinsics \
                else torch.zeros_like(J["ext"])
            Jp = J["point"] if (s.do_optimize_frames and Npv > 0) \
                else torch.zeros_like(J["point"])
            Je = Je * ext_valid_p
            Jp = Jp * point_var                  # fixed points: no gradient

            x_point = r.reshape(-1)
            E = E + torch.sum(r * r)

            gi = torch.einsum("omi,om->oi", Ji, r)
            ge = torch.einsum("omi,om->oi", Je, r)
            gp = torch.einsum("omi,om->oi", Jp, r)
            if Npv:
                g_p[:Npv] += _seg(gp, ipt_c, Npv)
                Hpp[:Npv] += _seg(torch.einsum("omi,omj->oij", Jp, Jp),
                                  ipt_c, Npv)
            for (ci, ce), oid in pairs_p:
                Ji_p, Je_p, Jp_p = (_take(Ji, oid), _take(Je, oid),
                                    _take(Jp, oid))
                ipt_p = _take(ipt_c, oid)
                i0 = cl.coli(ci)
                g_c[i0:i0 + Nip] += torch.sum(_take(gi, oid), dim=0)
                Hcc[i0:i0 + Nip, i0:i0 + Nip] += \
                    torch.einsum("omi,omj->ij", Ji_p, Ji_p)
                if Npv:
                    Cp[:, :, i0:i0 + Nip] += _seg(
                        torch.einsum("omi,omj->oij", Jp_p, Ji_p), ipt_p, Npv)
                if ce >= 0:
                    e0 = cl.cole(ce)
                    g_c[e0:e0 + 6] += torch.sum(_take(ge, oid), dim=0)
                    Hcc[e0:e0 + 6, e0:e0 + 6] += \
                        torch.einsum("omi,omj->ij", Je_p, Je_p)
                    Hie = torch.einsum("omi,omj->ij", Ji_p, Je_p)
                    Hcc[i0:i0 + Nip, e0:e0 + 6] += Hie
                    Hcc[e0:e0 + 6, i0:i0 + Nip] += Hie.T
                    if Npv:
                        Cp[:, :, e0:e0 + 6] += _seg(
                            torch.einsum("omi,omj->oij", Jp_p, Je_p),
                            ipt_p, Npv)

        # ---------------- triangulated-point pairs ----------------
        x_tri = zeros((0,))
        if Ntri:
            x_tri, J0, J1 = rows_of.tri(pk, arrays)
            E = E + torch.sum(x_tri * x_tri)
            if tri_ext:
                # the pairs' dense rows over the extrinsics, (Ntri, 6*Nce)
                Jrow = zeros((Ntri, spec.Ncameras_extrinsics + 1, 6))
                Jrow[tri_rows, rows_of.ie0] = J0
                Jrow.index_put_((tri_rows, rows_of.ie1), J1, accumulate=True)
                Jrow = Jrow.reshape(Ntri, -1)[:, 6:]       # drop ref cam
                Hcc[cl.e0:cl.w0, cl.e0:cl.w0] += Jrow.T @ Jrow
                g_c[cl.e0:cl.w0] += Jrow.T @ x_tri

        # ---------------- regularization ----------------
        x_reg = zeros((0,))
        if spec.num_measurements_regularization:
            # per-camera reg rows depend on that camera's intrinsics state;
            # plus optionally one unity_cam01 row on extrinsics 0
            rreg, Jreg = rows_of.regularization(pk)
            E = E + torch.sum(rreg * rreg)
            if Jreg is not None:
                for ci in range(spec.Ncameras_intrinsics):
                    i0 = cl.coli(ci)
                    g_c[i0:i0 + Nip] += Jreg[ci].T @ rreg[ci]
                    Hcc[i0:i0 + Nip, i0:i0 + Nip] += Jreg[ci].T @ Jreg[ci]
            # the reference emits ALL distortion terms for all cameras,
            # then ALL centerpixel terms
            ndist_terms = (spec.Ndistortions
                           if (s.do_apply_regularization
                               and s.do_optimize_intrinsics_distortions)
                           else 0)
            x_reg = torch.cat([rreg[:, :ndist_terms].reshape(-1),
                               rreg[:, ndist_terms:].reshape(-1)])

            if (s.do_apply_regularization_unity_cam01
                    and s.do_optimize_extrinsics
                    and spec.Ncameras_extrinsics > 0):
                ru, Ju = rows_of.unity_cam01(pk)
                E = E + ru * ru
                e0 = cl.cole(0)
                g_c[e0:e0 + 6] += Ju * ru
                Hcc[e0:e0 + 6, e0:e0 + 6] += torch.outer(Ju, Ju)
                x_reg = torch.cat([x_reg, ru[None]])

        return dict(E=E, g_c=g_c, g_f=g_f, g_p=g_p, Hcc=Hcc, Hff=Hff,
                    Cf=Cf, Hpp=Hpp, Cp=Cp,
                    x_board=x_board, x_point=x_point, x_tri=x_tri,
                    x_reg=x_reg)

    return f


# ----------------------------------------------------------------------------
# splined models: the spline-window assembly
# ----------------------------------------------------------------------------

def _splined_fast_path_ok(spec: ProblemSpec):
    """The spline-window assembly takes the standard splined
    configuration: boards only, core locked, distortions optimized."""
    return (spec.is_splined
            and spec.Ncore_state == 0
            and spec.selections.do_optimize_intrinsics_distortions
            and spec.Nobservations_point == 0
            and spec.num_measurements_points_triangulated == 0
            and spec.Nobservations_board > 0)


def _one_hot(ids, n, dtype):
    """(n, len(ids)) with a 1 at [ids[j], j]: sums by segment become
    products, which are deterministic on the card (index_add_ is not)."""
    return (torch.arange(n, device=ids.device)[:, None]
            == ids[None, :]).to(dtype)


def build_normal_equations_splined(spec: ProblemSpec, arrays, static_idx,
                                   *, h32=False):
    """Normal equations of a splined model with the core locked, boards
    only.  Each corner's two rows depend on its pose blocks (autograd,
    two cotangents) and on the 2(order+1)^2 control points of its spline
    window (closed form).  They are written into dense camera-system rows
    (N, 2, Nc) with index_put_ (exact: a row's columns are distinct), and
    Hcc = rows^T rows, Cf = Jf^T rows per observation, as plain products.
    The gradient takes the tensor-product separability of the basis
    instead of the rows: g_knot[c, y, x, m] = sum_n [ici_n = c] ry[n, y]
    rx[n, x] f_m w r_nm, with rx, ry the basis weights scattered onto the
    grid.

    f(b, arrays, hessian=True) -> the dict of build_normal_equations;
    hessian=False gives E, the gradient and the residuals only, and skips
    the rows and their products (the lazy-Hessian mode).  h32: the rows
    and the H and C blocks in float32, the gradient in the state's dtype
    (the float64-gradient, float32-H scheme)."""
    s = spec.selections
    cl = _CLayout(spec)
    lm = spec.lensmodel
    Nf = spec.Nframes
    Nce = spec.Ncameras_extrinsics
    Nci = spec.Ncameras_intrinsics
    Npv = spec.Npoints_variable
    dt = arrays["intrinsics"].dtype
    dev = arrays["intrinsics"].device
    hdt = torch.float32 if h32 else dt
    rows_of = _ObservationRows(spec, arrays)
    consts = rows_of.consts
    HW = rows_of.HW
    M2 = 2 * HW
    idxb = torch.tensor(np.asarray(static_idx["board"]).reshape(-1, 3),
                        dtype=torch.int64, device=dev)
    Nob = len(idxb)
    N = Nob * HW
    ici_c = idxb[:, 1].repeat_interleave(HW)
    ice_c = idxb[:, 2].repeat_interleave(HW)
    oh_f = _one_hot(idxb[:, 0], Nf, dt)                  # (Nf, Nob)
    oh_fh = oh_f.to(hdt)
    oh_e = _one_hot(idxb[:, 2], Nce, dt)                 # (Nce, Nob)
    # every row index and the extrinsics columns of every corner row
    n_idx = torch.arange(N, device=dev)[:, None, None]
    m_idx = torch.arange(2, device=dev)[None, :, None]
    cole = (cl.e0 + 6 * torch.clamp_min(ice_c, 0))[:, None, None] + \
        torch.arange(6, device=dev)
    ext_valid = (ice_c >= 0).to(dt)[:, None, None]
    oh_ci = (_one_hot(ici_c, Nci, dt).T[:, :, None] if Nci > 1
             else None)                                  # (N, Nci, 1)
    reg_cache = {}

    def f(b, arrays, hessian=True):
        params = split_packed_state(b, arrays, spec, scales=consts.state)
        pk = rows_of.packed(params)
        obs_w = torch.clamp_min(arrays["observations_board"][..., 2],
                                0.0).reshape(-1)
        if hessian:
            r, J, Jw, wincols, (ix0, iy0, wx, wy) = \
                rows_of.splined_board(pk, arrays)
            Je = J["ext"] * ext_valid if s.do_optimize_extrinsics \
                else torch.zeros_like(J["ext"])
            Jf = J["frame"] if s.do_optimize_frames \
                else torch.zeros_like(J["frame"])
            Jwp = J["warp"] if spec.has_calobject_warp \
                else torch.zeros_like(J["warp"])
            JTr = {k: torch.einsum("nri,nr->ni", Jk, r)
                   for k, Jk in (("ext", Je), ("frame", Jf), ("warp", Jwp))}
        else:
            r, JTr, (ix0, iy0, wx, wy) = rows_of.splined_board(
                pk, arrays, jacobian=False)
            JTr = dict(
                ext=(JTr["ext"] * ext_valid[:, 0] if s.do_optimize_extrinsics
                     else torch.zeros_like(JTr["ext"])),
                frame=(JTr["frame"] if s.do_optimize_frames
                       else torch.zeros_like(JTr["frame"])),
                warp=(JTr["warp"] if spec.has_calobject_warp
                      else torch.zeros_like(JTr["warp"])))

        E = torch.sum(r * r)
        # ---- gradient: separable knot part, per-observation pose parts
        R = lm.order + 1
        offs = torch.arange(R, device=dev)
        rx = r.new_zeros((N, lm.Nx)).scatter_(
            1, ix0[:, None] - 1 + offs, wx)
        ry = r.new_zeros((N, lm.Ny)).scatter_(
            1, iy0[:, None] - 1 + offs, wy)
        f2r = r * pk["intr_full"][ici_c, :2] * obs_w[:, None]
        rya = ry if oh_ci is None else (oh_ci * ry[:, None, :]).reshape(
            N, Nci * lm.Ny)
        gk = rya.T @ (rx[:, :, None] * f2r[:, None, :]).reshape(N, -1)
        g_c = torch.cat([
            gk.reshape(-1),
            (oh_e @ JTr["ext"].reshape(Nob, HW, 6).sum(dim=1)).reshape(-1),
            JTr["warp"].sum(dim=0)])
        g_f = r.new_zeros((max(Nf, 1), 6))
        g_f[:Nf] = oh_f @ JTr["frame"].reshape(Nob, HW, 6).sum(dim=1)
        out = dict(E=E, g_c=g_c, g_f=g_f, g_p=r.new_zeros((max(Npv, 1), 3)),
                   x_board=r.reshape(-1), x_point=r.new_zeros((0,)),
                   x_tri=r.new_zeros((0,)))

        # ---- H and C: the dense camera-system rows and their products
        if hessian:
            rows = torch.zeros((N, 2, cl.Nc), dtype=hdt, device=dev)
            rows[n_idx, m_idx, wincols[:, None, :]] = Jw.to(hdt)
            if Nce:
                rows[n_idx, m_idx, cole] = Je.to(hdt)
            rows[:, :, cl.w0:cl.w0 + 2] = Jwp.to(hdt)
            rows2 = rows.reshape(2 * N, cl.Nc)
            Hcc = rows2.T @ rows2
            Jf_o = Jf.to(hdt).reshape(Nob, M2, 6)
            Cf = r.new_zeros((max(Nf, 1), 6, cl.Nc), dtype=hdt)
            Cf[:Nf] = (oh_fh @ torch.bmm(
                Jf_o.transpose(1, 2), rows.reshape(Nob, M2, cl.Nc)
            ).reshape(Nob, -1)).reshape(Nf, 6, cl.Nc)
            Hff = r.new_zeros((max(Nf, 1), 6, 6), dtype=hdt)
            Hff[:Nf] = (oh_fh @ torch.bmm(Jf_o.transpose(1, 2), Jf_o
                                          ).reshape(Nob, 36)).reshape(
                                              Nf, 6, 6)
            out.update(Hcc=Hcc, Hff=Hff, Cf=Cf,
                       Hpp=r.new_zeros((max(Npv, 1), 3, 3), dtype=hdt),
                       Cp=r.new_zeros((max(Npv, 1), 3, cl.Nc), dtype=hdt))

        # ---- regularization: linear in the control points, so its
        # Jacobian is taken once
        x_reg = r.new_zeros((0,))
        if s.do_apply_regularization:
            rreg = splined_regularization(
                pk["intr_full"][:, 4:].reshape(Nci, lm.Ny, lm.Nx, 2),
                *consts.reg_knots)                       # (Nci, nterms)
            if not reg_cache:
                Jreg = rows_of.regularization(pk)[1]     # (Nci, nterms, Nip)
                reg_cache.update(J=Jreg, JtJ=torch.einsum(
                    "cki,ckj->cij", Jreg, Jreg).to(hdt))
            E = E + torch.sum(rreg * rreg)
            g_c[:cl.e0] += torch.einsum("cki,ck->ci", reg_cache["J"],
                                        rreg).reshape(-1)
            if hessian:
                for ci in range(Nci):
                    i0 = cl.coli(ci)
                    out["Hcc"][i0:i0 + cl.Nip, i0:i0 + cl.Nip] += \
                        reg_cache["JtJ"][ci]
            x_reg = rreg.reshape(-1)
        if (s.do_apply_regularization_unity_cam01
                and s.do_optimize_extrinsics and Nce > 0):
            ru, Ju = rows_of.unity_cam01(pk)
            E = E + ru * ru
            e0 = cl.cole(0)
            g_c[e0:e0 + 6] += Ju * ru
            if hessian:
                out["Hcc"][e0:e0 + 6, e0:e0 + 6] += \
                    torch.outer(Ju, Ju).to(hdt)
            x_reg = torch.cat([x_reg, ru[None]])
        out.update(E=E, x_reg=x_reg)
        return out

    f.gradient = lambda b, arrays: f(b, arrays, hessian=False)
    return f


# ----------------------------------------------------------------------------
# Schur-reduced damped step
# ----------------------------------------------------------------------------

def _block_eliminate(A, C, g):
    """Factor the batch of small SPD blocks A and solve it against the
    coupling block C (B, n, Nc) and the gradient g (B, n), in one kernel
    launch on a CUDA tensor.  Returns (L, A^-1 C, A^-1 g); L serves the
    back-substitution."""
    L, X = cholesky_factor_solve(A, torch.cat([C, g[..., None]], dim=-1))
    return L, X[..., :-1], X[..., -1]


def _damping_diag(A):
    """Marquardt scaling diagonal for a (batched) SPD block: diag(A)
    clamped below by a relative floor, so barely-observed states still get
    positive damping."""
    d = torch.diagonal(A, dim1=-2, dim2=-1)
    floor = 1e-12 * torch.max(d) + 1e-30
    return torch.maximum(d, floor)


def _damped(A, lam, dd):
    n = A.shape[-1]
    return A + (lam * dd)[..., None] * torch.eye(n, dtype=A.dtype,
                                                 device=A.device)


def schur_step(ne, lam, spec: ProblemSpec):
    """Solve (JtJ + lam D) delta = -g exactly via block elimination of
    frame and point blocks, D = Marquardt diag(JtJ) scaling.  Returns
    (delta_c, delta_f, delta_p, pred) where pred is the model's predicted
    decrease of E: pred = -g.d + lam d.D.d.  lam: a 0-d tensor or a
    float.

    The H and C blocks may be in a lower dtype than the gradient (float32
    H under a float64 gradient): the factorizations and solves then run
    in H's dtype, and delta and pred come back in the gradient's."""
    dt = ne["g_c"].dtype
    hdt = ne["Hcc"].dtype
    lam = torch.as_tensor(lam, dtype=dt, device=ne["g_c"].device)
    if hdt == torch.float32:
        # f32-assembled H: its diag carries ~eps32 relative noise, so
        # H_red + lam*diag(H) goes indefinite once lam < ~2e-7; saturate
        # the EFFECTIVE damping (the LM control's lam may keep shrinking)
        lam = torch.clamp_min(lam, _F32_LAM_FLOOR)
    lam_h = lam.to(hdt)
    Nf = spec.Nframes
    Npv = spec.Npoints_variable
    dd_c = _damping_diag(ne["Hcc"])
    H_red = _damped(ne["Hcc"], lam_h, dd_c)
    g_red = ne["g_c"].to(hdt)

    if Nf:
        dd_f = _damping_diag(ne["Hff"][:Nf])
        Af = _damped(ne["Hff"][:Nf], lam_h, dd_f)
        Cf = ne["Cf"][:Nf]                                 # (Nf,6,Nc)
        gf = ne["g_f"][:Nf]
        gf_h = gf.to(hdt)
        L_f, AinvC, Ainvg = _block_eliminate(Af, Cf, gf_h)
        H_red = H_red - torch.einsum("fic,fid->cd", Cf, AinvC)
        g_red = g_red - torch.einsum("fic,fi->c", Cf, Ainvg)
    if Npv:
        dd_p = _damping_diag(ne["Hpp"][:Npv])
        Ap = _damped(ne["Hpp"][:Npv], lam_h, dd_p)
        Cp = ne["Cp"][:Npv]
        gp = ne["g_p"][:Npv]
        gp_h = gp.to(hdt)
        L_p, AinvCp, Ainvgp = _block_eliminate(Ap, Cp, gp_h)
        H_red = H_red - torch.einsum("fic,fid->cd", Cp, AinvCp)
        g_red = g_red - torch.einsum("fic,fi->c", Cp, Ainvgp)

    # not SPD -> NaN step (rejected by the LM loop), as LAPACK's potrf
    # leaves it; cholesky_ex does not raise and does not synchronize
    Lc, info = torch.linalg.cholesky_ex(H_red)
    Lc = torch.where(info == 0, Lc, torch.nan)
    delta_c_h = -torch.cholesky_solve(g_red[:, None], Lc)[:, 0]
    delta_c = delta_c_h.to(dt)

    pred = -torch.dot(ne["g_c"], delta_c) \
        + lam * torch.dot(delta_c, dd_c.to(dt) * delta_c)
    delta_f = ne["g_c"].new_zeros((max(Nf, 1), 6))
    if Nf:
        rhs = -(gf_h + torch.einsum("fic,c->fi", Cf, delta_c_h))
        delta_f = cholesky_solve_factored(L_f, rhs[..., None])[..., 0].to(dt)
        pred = pred - torch.sum(gf * delta_f) \
            + lam * torch.sum(delta_f * (dd_f.to(dt) * delta_f))
    delta_p = ne["g_c"].new_zeros((max(Npv, 1), 3))
    if Npv:
        rhs = -(gp_h + torch.einsum("fic,c->fi", Cp, delta_c_h))
        delta_p = cholesky_solve_factored(L_p, rhs[..., None])[..., 0].to(dt)
        pred = pred - torch.sum(gp * delta_p) \
            + lam * torch.sum(delta_p * (dd_p.to(dt) * delta_p))
    return delta_c, delta_f, delta_p, pred


def _delta_to_b(delta_c, delta_f, delta_p, spec: ProblemSpec):
    """Map the block step onto the packed state vector layout."""
    cl = _CLayout(spec)
    parts = []
    if spec.num_states_intrinsics:
        parts.append(delta_c[:cl.e0])
    if spec.num_states_extrinsics:
        parts.append(delta_c[cl.e0:cl.w0])
    if spec.num_states_frames:
        parts.append(delta_f[:spec.Nframes].reshape(-1))
    if spec.num_states_points:
        parts.append(delta_p[:spec.Npoints_variable].reshape(-1))
    if spec.num_states_calobject_warp:
        parts.append(delta_c[cl.w0:cl.w0 + 2])
    if not parts:
        return delta_c[:0]
    return torch.cat(parts)


def _g_to_b(ne, spec: ProblemSpec):
    cl = _CLayout(spec)
    parts = []
    if spec.num_states_intrinsics:
        parts.append(ne["g_c"][:cl.e0])
    if spec.num_states_extrinsics:
        parts.append(ne["g_c"][cl.e0:cl.w0])
    if spec.num_states_frames:
        parts.append(ne["g_f"][:spec.Nframes].reshape(-1))
    if spec.num_states_points:
        parts.append(ne["g_p"][:spec.Npoints_variable].reshape(-1))
    if spec.num_states_calobject_warp:
        parts.append(ne["g_c"][cl.w0:cl.w0 + 2])
    if not parts:
        return ne["g_c"][:0]
    return torch.cat(parts)


# ----------------------------------------------------------------------------
# LM loop
# ----------------------------------------------------------------------------

def _cast_arrays(arrays, dtype):
    """Cast the float arrays of the problem to `dtype` (ints unchanged)."""
    return {k: (v.to(dtype) if v.is_floating_point() else v)
            for k, v in arrays.items()}


def _effective_threshold(update_threshold, dtype, quiet=False):
    """f32 cannot resolve packed-state updates below ~1e-5: clamp the
    threshold, and tell the caller unless this is the mixed-precision
    pipeline's internal f32 phase (quiet=True there)."""
    if update_threshold == 0.0:
        # explicit 0 = no step-size termination at all (benchmark mode)
        return 0.0
    if dtype == torch.float32 and update_threshold < 1e-5:
        if not quiet:
            warnings.warn(
                f"f32 solve: raising update_threshold {update_threshold:g}"
                " -> 1e-5 (f32 cannot resolve smaller packed-state steps)."
                " Use precision='mixed' (f32 phase + f64 polish) for"
                " full-precision convergence.", stacklevel=3)
        return 1e-5
    return update_threshold


# the normal-equation entries a gradient-only evaluation refreshes
_LAZY_H_GRAD_KEYS = ("E", "g_c", "g_f", "g_p",
                     "x_board", "x_point", "x_tri", "x_reg")


def _make_grad_fn(spec: ProblemSpec):
    """E, the gradient and the residuals in ONE reverse pass: g = J^T x
    from autograd of 0.5 |x(b)|^2 through the full residual function,
    split into the solver's block layout.  The lazy-Hessian mode's
    gradient-only evaluation wherever the normal equations have none of
    their own."""
    cl = _CLayout(spec)
    Nf = spec.Nframes
    Npv = spec.Npoints_variable
    nb = spec.num_measurements_boards
    npt = spec.num_measurements_points
    nt = spec.num_measurements_points_triangulated

    def fn(b, arrays):
        with torch.enable_grad():
            bb = b.detach().requires_grad_(True)
            x = residuals_from_packed(bb, arrays, spec)
            (gb,) = torch.autograd.grad(0.5 * torch.sum(x * x), bb)
        x = x.detach()
        g_c = b.new_zeros(cl.Nc)
        i = 0
        if spec.num_states_intrinsics:
            g_c[:cl.e0] = gb[i:i + cl.e0]
            i += cl.e0
        if spec.num_states_extrinsics:
            g_c[cl.e0:cl.w0] = gb[i:i + cl.w0 - cl.e0]
            i += cl.w0 - cl.e0
        g_f = b.new_zeros((max(Nf, 1), 6))
        if spec.num_states_frames:
            g_f[:Nf] = gb[i:i + 6 * Nf].reshape(Nf, 6)
            i += 6 * Nf
        g_p = b.new_zeros((max(Npv, 1), 3))
        if spec.num_states_points:
            g_p[:Npv] = gb[i:i + 3 * Npv].reshape(Npv, 3)
            i += 3 * Npv
        if spec.num_states_calobject_warp:
            g_c[cl.w0:cl.w0 + 2] = gb[i:i + 2]
        return dict(E=torch.sum(x * x), g_c=g_c, g_f=g_f, g_p=g_p,
                    x_board=x[:nb], x_point=x[nb:nb + npt],
                    x_tri=x[nb + npt:nb + npt + nt],
                    x_reg=x[nb + npt + nt:])

    return fn


# the lazy-Hessian refresh interval of a splined float32 solve on the card
LAZY_H_K_SPLINED_F32 = 4


def _lazy_h_K(spec: ProblemSpec, dtype, device):
    """The default lazy-Hessian interval: K = 4 for a splined model's
    float32 solve on the card (its H assembly is most of the iteration),
    0 (exact H every iteration) otherwise, as the JAX package has it on an
    accelerator and on the CPU."""
    if spec.is_splined and dtype == torch.float32 \
            and torch.device(device).type == "cuda":
        return LAZY_H_K_SPLINED_F32
    return 0


def lm_solve(spec: ProblemSpec, arrays, b0, static_idx, *,
             max_iterations=300, update_threshold=1e-7, dtype=None,
             quiet=False, lam0=1e-4, ftol=None, lazy_K=None, h32=False):
    """Levenberg-Marquardt to convergence: the accept, lambda, small-step,
    16-iteration plateau and lambda>1e12 rules of the JAX package's
    device-resident loop, as one Python loop over tensors on the device of
    `arrays`.  Each iteration reads one scalar (accept and done).

    lazy_K > 0 is the lazy-Hessian mode: the H and C blocks refresh only
    on the (K+1)-th accepted step after the last refresh, while E, the
    gradient and the residuals are exact on every iteration (inexact
    Newton with a stale model; the gain-ratio control absorbs its error).
    None takes _lazy_h_K's default.  h32: the splined window assembly's
    float32 H under a float64 gradient.

    Returns (b, E, niter, ne) with E a 0-d tensor and ne the normal
    equations at b (residual vectors included; H possibly stale)."""
    if dtype is not None:
        arrays = _cast_arrays(arrays, dtype)
        b0 = b0.to(dtype)
    eff_threshold = _effective_threshold(update_threshold, b0.dtype, quiet)
    if ftol is None:
        # f32 grinds at its ~1e-7 relative-E precision floor; f64 at
        # roundoff.  Terminate when accepted improvements fall below it.
        ftol = 1e-5 if b0.dtype == torch.float32 else 1e-6
    if lazy_K is None:
        lazy_K = _lazy_h_K(spec, b0.dtype, b0.device)
    # benchmark mode (both thresholds exactly 0): run the full
    # max_iterations, no plateau or trust-region-collapse exits
    benchmark = eff_threshold <= 0.0 and ftol <= 0.0
    ne_fn = build_normal_equations(spec, arrays, static_idx, h32=h32)
    grad_fn = getattr(ne_fn, "gradient", None) or _make_grad_fn(spec)

    with torch.no_grad():
        b = b0
        ne = ne_fn(b, arrays)
        lam = torch.full((), lam0, dtype=b.dtype, device=b.device)
        nu = torch.full((), 2.0, dtype=b.dtype, device=b.device)
        E_ref, it_ref = ne["E"], 0
        it = 0
        # accepted steps since the last H refresh
        age = 0
        while it < max_iterations:
            dc, df, dp, pred = schur_step(ne, lam, spec)
            db = _delta_to_b(dc, df, dp, spec)
            b_try = b + db
            refresh = age >= lazy_K
            if refresh:
                ne_try = ne_fn(b_try, arrays)
            else:
                ne_try = dict(ne)                  # the stale H blocks
                new = grad_fn(b_try, arrays)
                ne_try.update({k: new[k] for k in _LAZY_H_GRAD_KEYS})
            E = ne["E"]
            E_try = ne_try["E"]
            rho = torch.where(pred > 0, (E - E_try) / pred, -1.0)
            finite = torch.isfinite(E_try)
            accept = (E_try < E) & finite
            # converged when the proposed step is below the threshold AND
            # non-worsening
            small = (torch.max(torch.abs(db)) < eff_threshold) & \
                (E_try <= E) & finite
            lam_up = lam * nu
            lam_down = torch.clamp_min(
                lam * torch.clamp_min(1.0 - (2.0 * rho - 1.0) ** 3,
                                      1.0 / 3.0), _LAM_FLOOR)
            lam = torch.where(accept,
                              torch.where(rho > 0, lam_down, lam / 2.0),
                              lam_up)
            nu = torch.where(accept, 2.0, nu * 2.0)
            lam = torch.clamp_max(lam, 1e20)
            # ftol over a WINDOW: 16 iterations with total relative E
            # improvement below 16*ftol -> grinding at the precision floor
            E_now = torch.where(accept, E_try, E)
            plateaued = torch.zeros((), dtype=torch.bool, device=b.device)
            if it + 1 - it_ref >= 16:
                plateaued = (E_ref - E_now) <= ftol * 16.0 * E_now
                E_ref, it_ref = E_now, it + 1
            done = small
            if not benchmark:
                done = done | plateaued | (lam > 1e12)
            flags = int((accept.to(torch.int32)
                         + 2 * done.to(torch.int32)).item())
            if flags & 1:
                b, ne = b_try, ne_try
                age = 0 if refresh else age + 1
            it += 1
            if flags & 2:
                break
    return b, ne["E"], it, ne


def _mark_outliers(spec: ProblemSpec, obs_board_np, x_board,
                   obs_tri_np=None, x_tri=None, px_tri=None, idx_tri=None,
                   extrinsics=None):
    """Reference markOutliers semantics: estimate the residual variance
    from the current inliers (board and triangulated measurements pooled);
    if any inlier component exceeds 5 sigma, flip the weight sign of every
    component above 4 sigma.

    Triangulated pairs:
      - a pair whose Lee-Civera Mid2 triangulation is DIVERGENT under the
        current extrinsics is an outlier unconditionally (both of its
        observations are marked), and forces a re-solve;
      - the per-pair scalar ray-divergence residuals share the board
        residuals' k0/k1 sigma thresholds.

    Host code: numpy, and the port's Mid2 on CPU tensors.  Mutates
    obs_board_np and obs_tri_np (weight sign = outlier bit, column 2).
    Returns (found_new, Noutliers_board, Noutliers_triangulated)."""
    k0, k1 = 4.0, 5.0
    found = False
    var_sum = 0.0
    denom = 0

    have_board = obs_board_np is not None and obs_board_np.size
    if have_board:
        W = spec.calibration_object_width_n
        H = spec.calibration_object_height_n
        w = obs_board_np[..., 2]                    # (Nobs,H,W)
        r = np.asarray(x_board).reshape(-1, H, W, 2)
        inlier_b = w > 0.0
        Nout_b = int(np.sum(~inlier_b))
        var_sum += float(np.sum(r[inlier_b] ** 2))
        denom += 2 * int(np.sum(inlier_b))
    else:
        Nout_b = 0

    Nout_t = 0
    have_tri = obs_tri_np is not None and len(obs_tri_np)
    if have_tri:
        i0, i1 = triangulated_pair_indices(spec.triangulated_set_sizes)
        # divergent triangulations are DEFINITELY outliers
        ext = np.asarray(extrinsics, np.float64).reshape(-1, 6)
        ext_pad = torch.as_tensor(np.vstack([np.zeros((1, 6)), ext]))
        ice = np.asarray(idx_tri)[:, 2]
        px = torch.as_tensor(np.asarray(px_tri, np.float64))
        v0_cam1, t_10 = triangulated_pair_geometry(
            ext_pad[ice[i0] + 1], ext_pad[ice[i1] + 1], px[i0])
        m = _leecivera_mid2(px[i1], v0_cam1, t_10).numpy()
        divergent = np.all(m == 0.0, axis=-1)

        w_t = obs_tri_np[:, 2]
        pair_inlier = (w_t[i0] > 0) & (w_t[i1] > 0)
        new_div = divergent & pair_inlier
        if np.any(new_div):
            bad_obs = np.zeros(len(w_t), bool)
            bad_obs[i0[new_div]] = True
            bad_obs[i1[new_div]] = True
            obs_tri_np[bad_obs & (w_t > 0), 2] *= -1.0
            found = True
        w_t = obs_tri_np[:, 2]
        pair_inlier = (w_t[i0] > 0) & (w_t[i1] > 0)
        Nout_t = int(np.sum(~pair_inlier))
        xt = np.asarray(x_tri).reshape(-1)
        var_sum += float(np.sum(xt[pair_inlier] ** 2))
        denom += int(np.sum(pair_inlier))

    if denom == 0:
        return found, Nout_b, Nout_t
    var = var_sum / denom

    # any inlier measurement past the k1 trigger? (not needed when a
    # divergent pair already forces a re-solve)
    trigger = found
    if not trigger and have_board:
        trigger = bool(np.any((r ** 2 > (k1 * k1) * var)
                              & inlier_b[..., None]))
    if not trigger and have_tri:
        trigger = bool(np.any(pair_inlier & (xt ** 2 > (k1 * k1) * var)))
    if not trigger:
        return False, Nout_b, Nout_t

    # cull everything past k0 (margin to make the re-solve the last one)
    if have_board:
        mark = np.any(r ** 2 > (k0 * k0) * var, axis=-1) & inlier_b
        obs_board_np[..., 2][mark] *= -1.0
        Nout_b += int(np.sum(mark))
    if have_tri:
        bad_pair = pair_inlier & (xt ** 2 > (k0 * k0) * var)
        if np.any(bad_pair):
            w_t = obs_tri_np[:, 2]
            bad_obs = np.zeros(len(w_t), bool)
            bad_obs[i0[bad_pair]] = True
            bad_obs[i1[bad_pair]] = True
            obs_tri_np[bad_obs & (w_t > 0), 2] *= -1.0
        w_t = obs_tri_np[:, 2]
        Nout_t = int(np.sum(~((w_t[i0] > 0) & (w_t[i1] > 0))))
    return True, Nout_b, Nout_t


def _fetch_solution_np(b, ne, E):
    """ONE device->host readback of everything optimize() needs on the
    host: packed state, residual vectors, E (as float64 numpy)."""
    pieces = [b.reshape(-1), ne["x_board"].reshape(-1),
              ne["x_point"].reshape(-1), ne["x_tri"].reshape(-1),
              ne["x_reg"].reshape(-1), E.reshape(1).to(b.dtype)]
    sizes = [int(p.shape[0]) for p in pieces]
    flat = torch.cat(pieces).cpu().numpy().astype(np.float64)
    out = {}
    off = 0
    for name, n in zip(("b", "x_board", "x_point", "x_tri", "x_reg", "E"),
                       sizes):
        out[name] = flat[off:off + n]
        off += n
    out["E"] = float(out["E"][0])
    return out


def _unpack_state_np(b_np, spec: ProblemSpec):
    """Host-side (numpy) unpack of the packed state into the OPTIMIZED
    parameter blocks."""
    bu = np.asarray(b_np, np.float64) * spec.scales()
    out = {}
    i = 0
    n = spec.num_states_intrinsics
    if n:
        out["intrinsics_state"] = bu[i:i + n].reshape(
            spec.Ncameras_intrinsics, spec.Nintrinsics_state_per_cam)
        i += n
    n = spec.num_states_extrinsics
    if n:
        out["extrinsics"] = bu[i:i + n].reshape(-1, 6)
        i += n
    n = spec.num_states_frames
    if n:
        out["frames"] = bu[i:i + n].reshape(-1, 6)
        i += n
    n = spec.num_states_points
    if n:
        out["points"] = bu[i:i + n].reshape(-1, 3)
        i += n
    if spec.num_states_calobject_warp:
        out["calobject_warp"] = bu[i:i + 2]
    return out


class _SolveTimer:
    """Wall time of each phase of one optimize() call (host clock; every
    solve phase ends in a device->host read, so its time is complete)."""

    def __init__(self):
        self.t = {}

    @contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.t[name] = self.t.get(name, 0.0) + time.perf_counter() - t0


def _check_options(kw):
    for key, where in _NOT_PORTED_OPTIONS.items():
        if kw.get(key):
            raise NotImplementedError(f"optimize({key}=...) is not ported "
                                      f"yet: {where}")
    if kw.get("device_loop") is False:
        raise NotImplementedError(
            "optimize(device_loop=False): the port has one LM loop")


def optimize(*, device=None, **kw):
    """Full solve: the mrcal.optimize equivalent.

    device: where the solve runs; None means the CUDA card (and raises
    without one), "cpu" runs on the CPU.  precision: 'f64' (default),
    'f32', or 'mixed' (f32 phase to approximate convergence, then an f64
    polish).

    Mutates the input numpy arrays (intrinsics, extrinsics_rt_fromref,
    frames_rt_toref, points, calobject_warp, and observation weights for
    outlier marking) like the reference does, and returns a stats dict.
    check_gradient=True compares the Jacobian with central differences
    instead, and returns that report without solving."""
    _check_options(kw)
    device = resolve_device(device)
    timer = _SolveTimer()
    kw = _layout.normalize_inputs(kw)
    max_iterations = int(kw.get("max_iterations", 300))
    update_threshold = float(kw.get("update_threshold", 1e-7))
    spec = spec_from_inputs(**kw)
    require_ported(spec.lensmodel)

    # the caller's arrays, mutated in place by outlier marking
    np_obs_board = np.asarray(kw["observations_board"]) \
        if kw.get("observations_board") is not None else None
    np_obs_tri = np.asarray(kw["observations_point_triangulated"]) \
        if kw.get("observations_point_triangulated") is not None else None
    if np_obs_tri is not None and not len(np_obs_tri):
        np_obs_tri = None

    with timer.phase("pack"):
        arrays = arrays_from_inputs(kw, device=device, dtype=DEFAULT_DTYPE)
        b = pack_params(params_from_arrays(arrays), spec)

    def _idx_np(name):
        a = kw.get(name)
        return (np.zeros((0, 3), np.int64) if a is None
                else np.asarray(a, np.int64).reshape(-1, 3))
    static_idx = dict(
        board=_idx_np("indices_frame_camintrinsics_camextrinsics"),
        point=_idx_np("indices_point_camintrinsics_camextrinsics"))

    if kw.get("check_gradient"):
        # the reference's semantics: check the Jacobian column by column
        # against finite differences, and return without solving
        from .jacobian import _check_gradient_report
        return _check_gradient_report(spec, arrays, b)

    precision = kw.get("precision")
    if precision is None:
        mp = kw.get("mixed_precision")
        precision = "f64" if mp is None else ("mixed" if mp else "f64")
    if precision not in ("mixed", "f32", "f64"):
        raise ValueError(f"unknown precision={precision!r}")
    ftol = kw.get("ftol")

    def solve(b, **solve_kw):
        solve_kw.setdefault("max_iterations", max_iterations)
        solve_kw.setdefault("update_threshold", update_threshold)
        if ftol is not None:
            solve_kw.setdefault("ftol", ftol)
        return lm_solve(spec, arrays, b, static_idx, **solve_kw)

    total_niter = 0
    niter_polish = 0
    Noutliers = 0
    Noutliers_tri = 0
    outlier_loop = spec.selections.do_apply_outlier_rejection and (
        spec.Nobservations_board or np_obs_tri is not None)
    px_tri_np = idx_tri_np = None
    if outlier_loop and np_obs_tri is not None:
        px_tri_np = arrays["px_triangulated"].cpu().numpy()
        idx_tri_np = arrays["indices_triangulated"].cpu().numpy()
    while True:
        if precision == "f32":
            with timer.phase("solve_f32"):
                b, E, niter, ne = solve(b, dtype=torch.float32, quiet=True)
        elif precision == "mixed":
            f32_kw = {}
            if kw.get("ftol_f32") is not None:
                f32_kw["ftol"] = float(kw["ftol_f32"])
            with timer.phase("solve_f32"):
                b32, _, niter32, _ = solve(b, dtype=torch.float32,
                                           quiet=True, **f32_kw)
            b = b32.to(torch.float64)
            with timer.phase("solve_polish_f64"):
                b, E, niter, ne = solve(b, max_iterations=300,
                                        update_threshold=update_threshold)
            niter_polish += niter
            niter += niter32
        else:
            with timer.phase("solve_f64"):
                b, E, niter, ne = solve(b)
        total_niter += niter
        with timer.phase("fetch"):
            sol = _fetch_solution_np(b, ne, E)
        blocks_np = _unpack_state_np(sol["b"], spec)
        if not outlier_loop:
            break
        with timer.phase("outlier_rejection"):
            found, Noutliers, Noutliers_tri = _mark_outliers(
                spec, np_obs_board, sol["x_board"], obs_tri_np=np_obs_tri,
                x_tri=sol["x_tri"], px_tri=px_tri_np, idx_tri=idx_tri_np,
                extrinsics=blocks_np.get("extrinsics",
                                         kw.get("extrinsics_rt_fromref")))
        if not found:
            break
        for name, a in (("observations_board", np_obs_board),
                        ("observations_point_triangulated", np_obs_tri)):
            if a is not None:
                arrays[name] = torch.as_tensor(a, dtype=arrays[name].dtype,
                                               device=device)

    # write back the solution (only the OPTIMIZED slices)
    if "intrinsics_state" in blocks_np and kw.get("intrinsics") is not None:
        intr_np = np.asarray(kw["intrinsics"])
        blk = blocks_np["intrinsics_state"]
        j = 0
        if spec.Ncore_state:
            intr_np[:, :4] = blk[:, :4]
            j = 4
        if spec.selections.do_optimize_intrinsics_distortions:
            intr_np[:, spec.Ncore:] = blk[:, j:]
    for name, key in (("extrinsics_rt_fromref", "extrinsics"),
                      ("frames_rt_toref", "frames")):
        a = kw.get(name)
        if key in blocks_np and a is not None and np.asarray(a).size:
            np.copyto(np.asarray(a), blocks_np[key])
    if "points" in blocks_np and kw.get("points") is not None \
            and np.asarray(kw["points"]).size:
        np.asarray(kw["points"])[:spec.Npoints_variable] = \
            blocks_np["points"]
    if "calobject_warp" in blocks_np \
            and kw.get("calobject_warp") is not None:
        np.copyto(np.asarray(kw["calobject_warp"]),
                  blocks_np["calobject_warp"])

    x = np.concatenate([sol["x_board"], sol["x_point"], sol["x_tri"],
                        sol["x_reg"]])
    return dict(
        rms_reproj_error__pixels=float(
            np.sqrt(sol["E"] / max(spec.Nmeasurements, 1))),
        Noutliers=Noutliers,
        Noutliers_board=Noutliers,
        Noutliers_triangulated_point=Noutliers_tri,
        niterations=total_niter,
        niterations_polish=niter_polish,
        time_s={k: round(v, 6) for k, v in timer.t.items()},
        b_packed=sol["b"],
        x=x,
    )


def optimize_batch(*args, **kwargs):
    """Not ported yet: ROADMAP queue 1 item 10 (batched solves)."""
    raise NotImplementedError(
        "optimize_batch is not ported yet: ROADMAP queue 1 item 10 "
        "(batched solves)")
