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
  - batched solves (``optimize_batch``, ``lm_solve_batch``,
    ``pad_problems_to_common_structure``): the normal equations (the
    spline-window assembly too) and the Schur step take a leading problem
    axis, so P problems of one structure iterate in lockstep with one
    kernel launch per block type for all of them, each with its own
    lazy-Hessian refresh count; ``optimize()`` runs through the same code
    as a batch of one
"""

import warnings

import numpy as np
import torch

from .. import profiling
from .._config import DEFAULT_DTYPE, resolve_device
from ..lensmodels import (bspline_weights, project_core,
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
    corner grid xy, observed corners, core (N, 4), control points of
    every camera of every problem (P*Nci, Ny, Nx, 2), each corner's
    camera among them (N,), the fixed warp (N, 2)) -> (N, 2), and as aux
    the window origins (ix0, iy0) and the basis weights (wx, wy) (N, R),
    without gradient.  The window origin carries no gradient; the local
    coordinates within it carry the pose's."""
    lm = spec.lensmodel
    R = lm.order + 1

    def fn(blocks, cxy, obs_c, core4, coeffs, cam, warp_fixed):
        p_cam = _board_corners_cam(spec, consts, blocks, cxy, warp_fixed)
        u = stereographic_uv(p_cam)
        ix0, iy0, tx, ty = splined_window_index(u, lm)
        offs = torch.arange(R, device=u.device)
        win = coeffs[cam[:, None, None],
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


def _batch_of_one(arrays):
    """A problem's arrays as a batch of one: a leading problem axis of
    length 1 on every float array (the index arrays are shared)."""
    return {k: (v[None] if v.is_floating_point() else v)
            for k, v in arrays.items()}


class _ObservationRows:
    """The residual rows of each kind of observation and their Jacobians
    over the observation's own packed blocks, on the device and in the
    dtype of `arrays`: board rows per corner, point rows per observation,
    triangulated rows per pair.  The normal equations and the sparse
    Jacobian both take their rows from here.

    Every method takes a batch of P problems of one structure: packed
    blocks and float arrays lead with P, the index arrays are shared, and
    the rows of all P problems go through one autograd pass (each row
    depends on its own copy of its blocks only, so the per-row Jacobians
    stay exact).

    The observation counts are those of `arrays` (a shard of a problem
    holds fewer than its spec says), and pairs = (i0, i1), host arrays,
    gives the triangulated pairs as rows of arrays' triangulated
    observations, in place of the spec's sets."""

    def __init__(self, spec: ProblemSpec, arrays, pairs=None):
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
            self.cxy = _corner_grid(spec, len(arrays["indices_board"]), dt,
                                    dev)
        if spec.Nobservations_point:
            self.point_fn = _make_point_fn(spec, self.consts)
        if spec.num_measurements_points_triangulated:
            self.tri_fn = _make_tri_fn(self.consts)
            if pairs is None:
                pairs = triangulated_pair_indices(
                    spec.triangulated_set_sizes)
            self.i0, self.i1 = (torch.as_tensor(a, device=dev)
                                for a in pairs)
            ice = arrays["indices_triangulated"][:, 2]
            # the pairs' cameras, as rows of the padded extrinsics
            self.ie0, self.ie1 = ice[self.i0] + 1, ice[self.i1] + 1

    def packed(self, params):
        """The packed blocks of a parameter dict in real units: the
        intrinsics state (Nci, Nip), the full intrinsics (real units), the
        extrinsics with an identity row first for the camera at the
        reference (Nce + 1, 6), the frames, points and warp; each with
        the parameters' leading problem axis, if they have one."""
        s, c = self.spec.selections, self.consts
        intr_full = params["intrinsics"]
        cols = []
        if self.spec.Ncore_state:
            cols.append(intr_full[..., :4])
        if s.do_optimize_intrinsics_distortions:
            cols.append(intr_full[..., self.spec.Ncore:])
        ext = params["extrinsics"] / c.ext
        return dict(
            intr=(torch.cat(cols, dim=-1) / c.intr if cols
                  else intr_full[..., :0]),
            intr_full=intr_full,
            ext=ext,
            ext_pad=torch.cat([ext.new_zeros(ext.shape[:-2] + (1, 6)), ext],
                              dim=-2),
            frame=params["frames"] / c.frame,
            point=params["points"] / c.point,
            warp=params["calobject_warp"] / c.warp,
            warp_real=params["calobject_warp"])

    def board(self, pk, arrays):
        """-> r (P, Nobs*H*W, 2) and J {intr, ext, frame, warp: (P,
        Nobs*H*W, 2, n)}.  Every corner gets its own copy of its
        observation's blocks."""
        idx = arrays["indices_board"]
        ifr, ici, ice = idx[:, 0], idx[:, 1], idx[:, 2]
        P, Nobs = pk["intr_full"].shape[0], len(idx)

        def per_corner(t):                       # (P, Nobs, n) -> (P*N, n)
            # (explicit sizes: n may be 0, as with no intrinsics optimized)
            return t.repeat_interleave(self.HW, dim=1).reshape(
                P * Nobs * self.HW, t.shape[-1])

        blocks = dict(intr=pk["intr"][:, ici], ext=pk["ext_pad"][:, ice + 1],
                      frame=pk["frame"][:, ifr],
                      warp=pk["warp"][:, None].expand(P, Nobs, 2))
        r, J = _rows_and_jacobian(
            self.board_fn, {k: per_corner(v) for k, v in blocks.items()},
            self.cxy.repeat(P, 1), arrays["observations_board"].reshape(-1, 3),
            per_corner(pk["intr_full"][:, ici]),
            per_corner(pk["warp_real"][:, None].expand(P, Nobs, 2)))
        return r.reshape(P, -1, 2), {
            k: v.reshape(P, Nobs * self.HW, 2, v.shape[-1])
            for k, v in J.items()}

    def splined_board(self, pk, arrays, jacobian=True):
        """The board rows of a splined model with the core locked, per
        corner, for P problems: r (P, N, 2), the pose Jacobian {ext,
        frame, warp: (P, N, 2, n)}, the window Jacobian Jw (P, N, 2, 2R^2)
        over the window's control points, their columns in the
        camera-system layout wincols (P, N, 2R^2), and the windows' (ix0,
        iy0 (P, N), wx, wy (P, N, R)).  q is linear in the window:
        dr_k/dwin[jy, jx, m] = w f_k wy[jy] wx[jx] delta_km, in packed
        units since the distortions' packing scale is 1.
        jacobian=False: J^T r per corner {ext, frame, warp: (P, N, n)} in
        place of the pose Jacobian, and no Jw."""
        assert _layout.SCALE_DISTORTION == 1.0
        spec = self.spec
        lm = spec.lensmodel
        R = lm.order + 1
        idx = arrays["indices_board"]
        ifr, ici, ice = idx[:, 0], idx[:, 1], idx[:, 2]
        intr_full = pk["intr_full"]
        P, Nci = intr_full.shape[:2]
        Nobs = len(idx)
        ici_c = ici.repeat_interleave(self.HW)

        def per_corner(t):                       # (P, Nobs, n) -> (P*N, n)
            # (explicit sizes: n may be 0, as with no intrinsics optimized)
            return t.repeat_interleave(self.HW, dim=1).reshape(
                P * Nobs * self.HW, t.shape[-1])

        blocks = dict(ext=pk["ext_pad"][:, ice + 1],
                      frame=pk["frame"][:, ifr],
                      warp=pk["warp"][:, None].expand(P, Nobs, 2))
        core4 = intr_full[:, ici_c, :4].reshape(-1, 4)
        # every problem's cameras, one after the other
        coeffs = intr_full[..., 4:].reshape(P * Nci, lm.Ny, lm.Nx, 2)
        cam = (torch.arange(P, device=idx.device)[:, None] * Nci
               + ici_c).reshape(-1)
        obs_c = arrays["observations_board"].reshape(-1, 3)
        args = ({k: per_corner(v) for k, v in blocks.items()},
                self.cxy.repeat(P, 1), obs_c, core4, coeffs, cam,
                per_corner(pk["warp_real"][:, None].expand(P, Nobs, 2)))

        def lead(t):
            return t.reshape((P, -1) + t.shape[1:])

        if not jacobian:
            r, JTr, aux = _rows_and_vjp(self.splined_fn, *args)
            return (lead(r), {k: lead(v) for k, v in JTr.items()},
                    tuple(lead(t) for t in aux))
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
        wincols = (ici_c.repeat(P)[:, None, None, None]
                   * spec.Nintrinsics_state_per_cam
                   + 2 * knot[..., None]
                   + torch.arange(2, device=r.device)).reshape(N, -1)
        return (lead(r), {k: lead(v) for k, v in J.items()}, lead(Jw),
                lead(wincols), tuple(lead(t) for t in (ix0, iy0, wx, wy)))

    def point(self, pk, arrays):
        """-> r (P, Nobs, 2) and J {intr, ext, point: (P, Nobs, 2, n)};
        fixed points pass their real position / scale."""
        idx = arrays["indices_point"]
        ipt, ici, ice = idx[:, 0], idx[:, 1], idx[:, 2]
        P = pk["intr_full"].shape[0]

        def flat(t):
            return t.reshape(t.shape[0] * t.shape[1], t.shape[-1])

        r, J = _rows_and_jacobian(
            self.point_fn, dict(intr=flat(pk["intr"][:, ici]),
                                ext=flat(pk["ext_pad"][:, ice + 1]),
                                point=flat(pk["point"][:, ipt])),
            flat(arrays["observations_point"]),
            flat(pk["intr_full"][:, ici]))
        return r.reshape(P, -1, 2), {k: v.reshape(P, len(idx), 2, v.shape[-1])
                                     for k, v in J.items()}

    def tri(self, pk, arrays):
        """-> x (P, Npairs) and the Jacobians over the pair's two cameras'
        packed rt blocks, J0 and J1 (P, Npairs, 6); 0 for a pair with an
        outlier observation."""
        px = arrays["px_triangulated"]
        w = arrays["observations_point_triangulated"][..., 2]
        P = px.shape[0]
        r, J = _rows_and_jacobian(
            self.tri_fn, dict(rt0=pk["ext_pad"][:, self.ie0].reshape(-1, 6),
                              rt1=pk["ext_pad"][:, self.ie1].reshape(-1, 6)),
            px[:, self.i0].reshape(-1, 3), px[:, self.i1].reshape(-1, 3))
        valid = (w[:, self.i0] > 0) & (w[:, self.i1] > 0)
        # where, not multiply: an outlier pair's err/J may be NaN
        return (torch.where(valid, r.reshape(P, -1), 0.0),
                torch.where(valid[..., None], J["rt0"].reshape(P, -1, 6),
                            0.0),
                torch.where(valid[..., None], J["rt1"].reshape(P, -1, 6),
                            0.0))

    def regularization(self, pk):
        """The per-camera regularization rows (P, Nci, nterms), distortions
        then center pixel, and their Jacobians over the camera's
        intrinsics state (P, Nci, nterms, Nip), None without one."""
        spec, consts = self.spec, self.consts

        def reg_fn_cam(intr_state_1, intr_fixed_1, target_1):
            intr1 = _merge_intrinsics(intr_state_1, intr_fixed_1, spec,
                                      consts.intr)
            return _reg_per_camera(intr1, spec, consts, target_1)

        P, Nci = pk["intr_full"].shape[:2]
        args = (pk["intr"].reshape(P * Nci, -1),
                pk["intr_full"].reshape(P * Nci, -1),
                consts.reg_targets.repeat(P, 1))
        rreg = torch.func.vmap(reg_fn_cam)(*args)
        Jreg = (torch.func.vmap(torch.func.jacrev(reg_fn_cam))(*args)
                if pk["intr"].shape[-1] and rreg.shape[-1] else None)
        return (rreg.reshape(P, Nci, -1),
                None if Jreg is None else Jreg.reshape(
                    (P, Nci) + Jreg.shape[1:]))

    def unity_cam01(self, pk):
        """The unity_cam01 row (|t| of extrinsics 0 held at 1) (P,) and
        its Jacobian over that camera's packed rt (P, 6)."""
        c = 0.1 / 0.01
        t0 = pk["ext"][:, 0, 3:] * _layout.SCALE_TRANSLATION_CAMERA
        ru = c * (torch.sum(t0 * t0, dim=-1) - 1.0)
        Ju = torch.cat([torch.zeros_like(t0),
                        c * 2.0 * t0 * _layout.SCALE_TRANSLATION_CAMERA],
                       dim=-1)
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
    """Observations `ids` of every problem of t (P, Nobs, ...)."""
    return t if ids is None else t[:, ids]


def _seg(x, ids, n):
    """segment_sum along the observation axis of x (P, Nobs, ...): sum
    each problem's rows into n segments by ids."""
    return x.new_zeros((x.shape[0], n) + x.shape[2:]).index_add_(1, ids, x)


class _PointScatter:
    """The point observations' terms of g_c, Hcc and Cp, each block kind
    by one index_add_ over all observations (the JAX package's one-hot
    pair assembly does the same sums as products), instead of a loop over
    the distinct (intrinsics, extrinsics) pairs: an SfM problem has a pair
    per frame.  The entries each observation adds to are static: their
    flat indices are made once here.  An observation of the reference
    camera, or of a fixed point, adds its zero rows like any other."""

    def __init__(self, cl, idxp, ipt_c, Npv):
        Nc, dev = cl.Nc, idxp.device
        self.intr = cl.Nip > 0
        self.ext = cl.Nce > 0
        self.points = Npv > 0
        ci = (cl.coli(0) + cl.Nip * idxp[:, 1])[:, None] \
            + torch.arange(cl.Nip, device=dev)
        ce = (cl.e0 + 6 * torch.clamp(idxp[:, 2], min=0))[:, None] \
            + torch.arange(6, device=dev)
        # rows of Cp: point ipt's row a starts at (3 ipt + a) Nc
        rows = (3 * ipt_c[:, None] + torch.arange(3, device=dev)) * Nc

        def block(r, c):
            """(O, len r, len c) flat indices of rows r x columns c."""
            return (r[:, :, None] + c[:, None, :]).reshape(-1)
        self.g_i, self.g_e = ci.reshape(-1), ce.reshape(-1)
        self.H_ii, self.H_ee = block(ci * Nc, ci), block(ce * Nc, ce)
        self.H_ie, self.H_ei = block(ci * Nc, ce), block(ce * Nc, ci)
        self.C_i, self.C_e = block(rows, ci), block(rows, ce)

    @staticmethod
    def _add(t, idx, v):
        t.view(t.shape[0], -1).index_add_(1, idx, v.reshape(t.shape[0], -1))

    def __call__(self, g_c, Hcc, Cp, gi, ge, Ji, Je, Jp, outer):
        add = self._add
        if self.intr:
            add(g_c, self.g_i, gi)
            add(Hcc, self.H_ii, outer(Ji, Ji))
            if self.points:
                add(Cp, self.C_i, outer(Jp, Ji))
        if self.ext:
            add(g_c, self.g_e, ge)
            add(Hcc, self.H_ee, outer(Je, Je))
            if self.intr:
                Hie = outer(Ji, Je)
                add(Hcc, self.H_ie, Hie)
                add(Hcc, self.H_ei, Hie.transpose(-1, -2))
            if self.points:
                add(Cp, self.C_e, outer(Jp, Je))


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
                           h32=False, regularization=True):
    """Returns a function f(b, arrays) -> dict(E, g_c, g_f, g_p, Hcc, Hff,
    Cf, Hpp, Cp, x_board, x_point, x_tri, x_reg) where b is the packed
    state; H/C are the block normal-equation pieces in packed coordinates.
    static_idx carries numpy copies of the index arrays (for the static
    per-camera-pair grouping), and optionally the triangulated pairs
    ("pairs", see _ObservationRows).  The constants live on the device and
    in the dtype of `arrays`.

    regularization=False leaves the regularization out (x_reg empty): a
    shard of the observations assembles its blocks without it, and
    f.add_regularization(b, arrays, ne) adds it once to the reduced
    blocks, in place on g_c and Hcc, and returns ne with E and x_reg
    updated.

    b (Nstate,) is one problem.  b (P, Nstate) is a batch of P problems of
    one structure: every float array of `arrays` then leads with P (the
    index arrays are shared), and so does every leaf of the result.  One
    problem is evaluated as a batch of one.

    Splined models with the core locked take the spline-window assembly
    (build_normal_equations_splined); its f also has a gradient-only
    mode, and it alone takes h32."""
    if _splined_fast_path_ok(spec):
        return build_normal_equations_splined(
            spec, arrays, static_idx, h32=h32, regularization=regularization)
    if h32:
        raise ValueError("h32: only the splined window assembly assembles "
                         "H in float32")
    return _one_or_batch(_build_normal_equations_batch(
        spec, arrays, static_idx, regularization=regularization))


def _one_or_batch(f):
    """f(b (P, Nstate), arrays, **kw) -> a dict with a leading P on every
    leaf, and f.add_regularization(b, arrays, ne, **kw), as functions that
    also take one problem (b (Nstate,)) and evaluate it as a batch of
    one.  The regularization of one problem goes in place into its g_c
    and (if ne has it) Hcc, as the batch's does."""
    def g(b, arrays, **kw):
        if b.dim() == 2:
            return f(b, arrays, **kw)
        return {k: v[0] for k, v in
                f(b[None], _batch_of_one(arrays), **kw).items()}

    def add_regularization(b, arrays, ne, **kw):
        if b.dim() == 2:
            return f.add_regularization(b, arrays, ne, **kw)
        one = {k: ne[k][None] for k in ("E", "g_c", "Hcc") if k in ne}
        out = f.add_regularization(b[None], _batch_of_one(arrays), one, **kw)
        return dict(ne, E=out["E"][0], x_reg=out["x_reg"][0])

    g.add_regularization = add_regularization
    return g


def _build_normal_equations_batch(spec: ProblemSpec, arrays, static_idx,
                                  regularization=True):
    """build_normal_equations for a batch: f(b (P, Nstate), arrays) -> the
    dict with a leading P on every leaf.  The problems' rows go through
    one autograd pass; every sum is per problem, with P in the tensor."""
    s = spec.selections
    cl = _CLayout(spec)
    Nf = spec.Nframes
    Npv = spec.Npoints_variable
    dt = arrays["intrinsics"].dtype
    dev = arrays["intrinsics"].device
    rows_of = _ObservationRows(spec, arrays, static_idx.get("pairs"))
    consts = rows_of.consts

    idxb_np = np.asarray(static_idx["board"]).reshape(-1, 3)
    idxp_np = np.asarray(static_idx["point"]).reshape(-1, 3)
    Nob = len(idxb_np) if spec.Nobservations_board else 0
    Nop = len(idxp_np) if spec.Nobservations_point else 0
    pairs_b = [(k, _pair_ids(v, Nob, dev))
               for k, v in _distinct_pairs(idxb_np[:, 1:3])] if Nob else []
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
        point_scatter = _PointScatter(cl, idxp, ipt_c, Npv)
    Ntri = (len(rows_of.i0) if spec.num_measurements_points_triangulated
            else 0)
    if Ntri:
        # triangulated points are not state: each pair's row touches only
        # its two cameras' extrinsics, in the Hcc/g_c blocks
        tri_rows = torch.arange(Ntri, device=dev)
        tri_ext = bool(s.do_optimize_extrinsics and spec.Ncameras_extrinsics)

    def f(b, arrays):
        P = b.shape[0]
        params = split_packed_state(b, arrays, spec, scales=consts.state)
        pk = rows_of.packed(params)

        Nc = cl.Nc
        zeros = b.new_zeros
        g_c = zeros((P, Nc))
        Hcc = zeros((P, Nc, Nc))
        g_f = zeros((P, max(Nf, 1), 6))
        Hff = zeros((P, max(Nf, 1), 6, 6))
        Cf = zeros((P, max(Nf, 1), 6, Nc))
        g_p = zeros((P, max(Npv, 1), 3))
        Hpp = zeros((P, max(Npv, 1), 3, 3))
        Cp = zeros((P, max(Npv, 1), 3, Nc))
        E = zeros((P,))
        x_board = zeros((P, 0))
        x_point = zeros((P, 0))
        w0, Nip = cl.w0, cl.Nip

        def outer(A, B):
            """sum over the rows m of each observation: (P, O, m, i) x
            (P, O, m, j) -> (P, O, i, j)"""
            return torch.einsum("pomi,pomj->poij", A, B)

        def outer_all(A, B):
            """... and over the observations too -> (P, i, j)"""
            return torch.einsum("pomi,pomj->pij", A, B)

        # ---------------- board observations ----------------
        if Nob:
            ifr = idxb[:, 0]
            r2, J2 = rows_of.board(pk, arrays)
            r = r2.reshape(P, Nob, M)
            J = {k: v.reshape(P, Nob, M, v.shape[-1]) for k, v in J2.items()}
            Ji = J["intr"] if Nip > 0 else torch.zeros_like(J["intr"])
            Je = J["ext"] if s.do_optimize_extrinsics \
                else torch.zeros_like(J["ext"])
            Jf = J["frame"] if s.do_optimize_frames \
                else torch.zeros_like(J["frame"])
            Jw = J["warp"] if spec.has_calobject_warp \
                else torch.zeros_like(J["warp"])
            # camera at reference: no extrinsics gradient
            Je = Je * ext_valid_b

            x_board = r.reshape(P, -1)
            E = E + torch.sum(r * r, dim=(1, 2))

            gi = torch.einsum("pomi,pom->poi", Ji, r)
            ge = torch.einsum("pomi,pom->poi", Je, r)
            gf = torch.einsum("pomi,pom->poi", Jf, r)
            gw = torch.einsum("pomi,pom->pi", Jw, r)
            g_c[:, w0:w0 + 2] += gw
            if Nf:
                g_f[:, :Nf] += _seg(gf, ifr, Nf)
                Hff[:, :Nf] += _seg(outer(Jf, Jf), ifr, Nf)
            # warp self + warp-frame cross
            Hcc[:, w0:w0 + 2, w0:w0 + 2] += outer_all(Jw, Jw)
            if Nf:
                Cf[..., w0:w0 + 2] += _seg(outer(Jf, Jw), ifr, Nf)

            # per distinct (ici,ice) pair: static column placement
            for (ci, ce), oid in pairs_b:
                Ji_p, Je_p, Jf_p, Jw_p = (_take(Ji, oid), _take(Je, oid),
                                          _take(Jf, oid), _take(Jw, oid))
                ifr_p = ifr if oid is None else ifr[oid]
                i0 = cl.coli(ci)
                g_c[:, i0:i0 + Nip] += torch.sum(_take(gi, oid), dim=1)
                Hcc[:, i0:i0 + Nip, i0:i0 + Nip] += outer_all(Ji_p, Ji_p)
                # intr-warp cross
                Hiw = outer_all(Ji_p, Jw_p)
                Hcc[:, i0:i0 + Nip, w0:w0 + 2] += Hiw
                Hcc[:, w0:w0 + 2, i0:i0 + Nip] += Hiw.transpose(1, 2)
                if Nf:
                    Cf[..., i0:i0 + Nip] += _seg(outer(Jf_p, Ji_p), ifr_p, Nf)
                if ce >= 0:
                    e0 = cl.cole(ce)
                    g_c[:, e0:e0 + 6] += torch.sum(_take(ge, oid), dim=1)
                    Hcc[:, e0:e0 + 6, e0:e0 + 6] += outer_all(Je_p, Je_p)
                    Hie = outer_all(Ji_p, Je_p)
                    Hcc[:, i0:i0 + Nip, e0:e0 + 6] += Hie
                    Hcc[:, e0:e0 + 6, i0:i0 + Nip] += Hie.transpose(1, 2)
                    Hew = outer_all(Je_p, Jw_p)
                    Hcc[:, e0:e0 + 6, w0:w0 + 2] += Hew
                    Hcc[:, w0:w0 + 2, e0:e0 + 6] += Hew.transpose(1, 2)
                    if Nf:
                        Cf[..., e0:e0 + 6] += _seg(outer(Jf_p, Je_p), ifr_p,
                                                   Nf)

        # ---------------- point observations ----------------
        if Nop:
            r, J = rows_of.point(pk, arrays)                 # (P,Nop,2)
            Ji = J["intr"] if Nip > 0 else torch.zeros_like(J["intr"])
            Je = J["ext"] if s.do_optimize_extrinsics \
                else torch.zeros_like(J["ext"])
            Jp = J["point"] if (s.do_optimize_frames and Npv > 0) \
                else torch.zeros_like(J["point"])
            Je = Je * ext_valid_p
            Jp = Jp * point_var                  # fixed points: no gradient

            x_point = r.reshape(P, -1)
            E = E + torch.sum(r * r, dim=(1, 2))

            gi = torch.einsum("pomi,pom->poi", Ji, r)
            ge = torch.einsum("pomi,pom->poi", Je, r)
            gp = torch.einsum("pomi,pom->poi", Jp, r)
            if Npv:
                g_p[:, :Npv] += _seg(gp, ipt_c, Npv)
                Hpp[:, :Npv] += _seg(outer(Jp, Jp), ipt_c, Npv)
            point_scatter(g_c, Hcc, Cp, gi, ge, Ji, Je, Jp, outer)

        # ---------------- triangulated-point pairs ----------------
        x_tri = zeros((P, 0))
        if Ntri:
            x_tri, J0, J1 = rows_of.tri(pk, arrays)
            E = E + torch.sum(x_tri * x_tri, dim=1)
            if tri_ext:
                # the pairs' dense rows over the extrinsics, (P, Ntri,
                # 6*Nce); within one assignment the (pair, camera) index
                # pairs are distinct, so += adds J1 onto J0 where a pair's
                # two observations share a camera
                Jrow = zeros((P, Ntri, spec.Ncameras_extrinsics + 1, 6))
                Jrow[:, tri_rows, rows_of.ie0] = J0
                Jrow[:, tri_rows, rows_of.ie1] += J1
                Jrow = Jrow.reshape(P, Ntri, -1)[..., 6:]   # drop ref cam
                Hcc[:, cl.e0:cl.w0, cl.e0:cl.w0] += \
                    Jrow.transpose(1, 2) @ Jrow
                g_c[:, cl.e0:cl.w0] += torch.einsum("ptk,pt->pk", Jrow,
                                                    x_tri)

        x_reg = zeros((P, 0))
        if regularization:
            E, x_reg = add_reg(pk, E, g_c, Hcc)
        return dict(E=E, g_c=g_c, g_f=g_f, g_p=g_p, Hcc=Hcc, Hff=Hff,
                    Cf=Cf, Hpp=Hpp, Cp=Cp,
                    x_board=x_board, x_point=x_point, x_tri=x_tri,
                    x_reg=x_reg)

    def add_reg(pk, E, g_c, Hcc):
        """The regularization rows added to E, and in place to g_c and Hcc
        (each with the leading P) -> (E, x_reg)."""
        P, Nip = E.shape[0], cl.Nip
        x_reg = E.new_zeros((P, 0))
        if not spec.num_measurements_regularization:
            return E, x_reg
        # per-camera reg rows depend on that camera's intrinsics state;
        # plus optionally one unity_cam01 row on extrinsics 0
        rreg, Jreg = rows_of.regularization(pk)
        E = E + torch.sum(rreg * rreg, dim=(1, 2))
        if Jreg is not None:
            for ci in range(spec.Ncameras_intrinsics):
                i0 = cl.coli(ci)
                g_c[:, i0:i0 + Nip] += torch.einsum(
                    "pki,pk->pi", Jreg[:, ci], rreg[:, ci])
                Hcc[:, i0:i0 + Nip, i0:i0 + Nip] += torch.einsum(
                    "pki,pkj->pij", Jreg[:, ci], Jreg[:, ci])
        # the reference emits ALL distortion terms for all cameras,
        # then ALL centerpixel terms
        ndist_terms = (spec.Ndistortions
                       if (s.do_apply_regularization
                           and s.do_optimize_intrinsics_distortions)
                       else 0)
        x_reg = torch.cat([rreg[..., :ndist_terms].reshape(P, -1),
                           rreg[..., ndist_terms:].reshape(P, -1)], dim=1)

        if (s.do_apply_regularization_unity_cam01
                and s.do_optimize_extrinsics
                and spec.Ncameras_extrinsics > 0):
            ru, Ju = rows_of.unity_cam01(pk)
            E = E + ru * ru
            e0 = cl.cole(0)
            g_c[:, e0:e0 + 6] += Ju * ru[:, None]
            Hcc[:, e0:e0 + 6, e0:e0 + 6] += Ju[:, :, None] * Ju[:, None]
            x_reg = torch.cat([x_reg, ru[:, None]], dim=1)
        return E, x_reg

    def add_regularization(b, arrays, ne):
        params = split_packed_state(b, arrays, spec, scales=consts.state)
        E, x_reg = add_reg(rows_of.packed(params), ne["E"], ne["g_c"],
                           ne["Hcc"])
        return dict(ne, E=E, x_reg=x_reg)

    f.add_regularization = add_regularization
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
                                   *, h32=False, regularization=True):
    """Normal equations of a splined model with the core locked, boards
    only.  Each corner's two rows depend on its pose blocks (autograd,
    two cotangents) and on the 2(order+1)^2 control points of its spline
    window (closed form).  They are written into dense camera-system rows
    (P, N, 2, Nc) with index_put_ (exact: a row's columns are distinct),
    and Hcc = rows^T rows (one batched product), Cf = Jf^T rows per
    observation, as plain products.  The gradient takes the
    tensor-product separability of the basis instead of the rows:
    g_knot[c, y, x, m] = sum_n [ici_n = c] ry[n, y] rx[n, x] f_m w r_nm,
    with rx, ry the basis weights scattered onto the grid.

    f(b, arrays, hessian=True) -> the dict of build_normal_equations, for
    one problem or for a batch of P (b (P, Nstate), every float array of
    `arrays` and every leaf of the result leading with P); hessian=False
    gives E, the gradient and the residuals only, and skips the rows and
    their products (the lazy-Hessian mode; also f.gradient).  h32: the
    rows and the H and C blocks in float32, the gradient in the state's
    dtype (the float64-gradient, float32-H scheme).  regularization and
    f.add_regularization(b, arrays, ne, hessian=True) as
    build_normal_equations has them."""
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
    # the rows' indices: (problem, corner, row) of every window entry, and
    # (corner, row) of the extrinsics columns of every corner row
    n4 = torch.arange(N, device=dev)[None, :, None, None]
    m4 = torch.arange(2, device=dev)[None, None, :, None]
    cole = (cl.e0 + 6 * torch.clamp_min(ice_c, 0))[:, None, None] + \
        torch.arange(6, device=dev)                      # (N, 1, 6)
    ext_valid = (ice_c >= 0).to(dt)[:, None, None]
    oh_ci = (_one_hot(ici_c, Nci, dt).T[:, :, None] if Nci > 1
             else None)                                  # (N, Nci, 1)
    reg_cache = {}

    def f(b, arrays, hessian=True):
        P = b.shape[0]
        params = split_packed_state(b, arrays, spec, scales=consts.state)
        pk = rows_of.packed(params)
        obs_w = torch.clamp_min(arrays["observations_board"][..., 2],
                                0.0).reshape(P, N)
        if hessian:
            r, J, Jw, wincols, (ix0, iy0, wx, wy) = \
                rows_of.splined_board(pk, arrays)
            Je = J["ext"] * ext_valid if s.do_optimize_extrinsics \
                else torch.zeros_like(J["ext"])
            Jf = J["frame"] if s.do_optimize_frames \
                else torch.zeros_like(J["frame"])
            Jwp = J["warp"] if spec.has_calobject_warp \
                else torch.zeros_like(J["warp"])
            JTr = {k: torch.einsum("pnri,pnr->pni", Jk, r)
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

        E = torch.sum(r * r, dim=(1, 2))
        # ---- gradient: separable knot part, per-observation pose parts
        R = lm.order + 1
        offs = torch.arange(R, device=dev)
        rx = r.new_zeros((P, N, lm.Nx)).scatter_(
            2, ix0[..., None] - 1 + offs, wx)
        ry = r.new_zeros((P, N, lm.Ny)).scatter_(
            2, iy0[..., None] - 1 + offs, wy)
        f2r = r * pk["intr_full"][:, ici_c, :2] * obs_w[..., None]
        rya = ry if oh_ci is None else (oh_ci * ry[:, :, None, :]).reshape(
            P, N, Nci * lm.Ny)
        gk = rya.transpose(1, 2) @ (rx[..., None] * f2r[:, :, None, :]
                                    ).reshape(P, N, -1)
        g_c = torch.cat([
            gk.reshape(P, -1),
            (oh_e @ JTr["ext"].reshape(P, Nob, HW, 6).sum(dim=2)).reshape(
                P, -1),
            JTr["warp"].sum(dim=1)], dim=1)
        g_f = r.new_zeros((P, max(Nf, 1), 6))
        g_f[:, :Nf] = oh_f @ JTr["frame"].reshape(P, Nob, HW, 6).sum(dim=2)
        out = dict(E=E, g_c=g_c, g_f=g_f,
                   g_p=r.new_zeros((P, max(Npv, 1), 3)),
                   x_board=r.reshape(P, -1), x_point=r.new_zeros((P, 0)),
                   x_tri=r.new_zeros((P, 0)))

        # ---- H and C: the dense camera-system rows and their products
        if hessian:
            rows = torch.zeros((P, N, 2, cl.Nc), dtype=hdt, device=dev)
            p4 = torch.arange(P, device=dev)[:, None, None, None]
            rows[p4, n4, m4, wincols[:, :, None, :]] = Jw.to(hdt)
            if Nce:
                rows[:, n4[0], m4[0], cole] = Je.to(hdt)
            rows[..., cl.w0:cl.w0 + 2] = Jwp.to(hdt)
            rows2 = rows.reshape(P, 2 * N, cl.Nc)
            Hcc = rows2.transpose(1, 2) @ rows2
            Jf_o = Jf.to(hdt).reshape(P, Nob, M2, 6)
            Cf = r.new_zeros((P, max(Nf, 1), 6, cl.Nc), dtype=hdt)
            Cf[:, :Nf] = (oh_fh @ (Jf_o.transpose(2, 3) @ rows.reshape(
                P, Nob, M2, cl.Nc)).reshape(P, Nob, -1)).reshape(
                    P, Nf, 6, cl.Nc)
            Hff = r.new_zeros((P, max(Nf, 1), 6, 6), dtype=hdt)
            Hff[:, :Nf] = (oh_fh @ (Jf_o.transpose(2, 3) @ Jf_o).reshape(
                P, Nob, 36)).reshape(P, Nf, 6, 6)
            out.update(Hcc=Hcc, Hff=Hff, Cf=Cf,
                       Hpp=r.new_zeros((P, max(Npv, 1), 3, 3), dtype=hdt),
                       Cp=r.new_zeros((P, max(Npv, 1), 3, cl.Nc),
                                      dtype=hdt))

        x_reg = r.new_zeros((P, 0))
        if regularization:
            E, x_reg = add_reg(pk, E, g_c, out.get("Hcc"))
        out.update(E=E, x_reg=x_reg)
        return out

    def add_reg(pk, E, g_c, Hcc):
        """The regularization rows added to E, and in place to g_c and
        (unless None) Hcc, each with the leading P -> (E, x_reg)."""
        # linear in the control points, so its Jacobian is taken once
        P = E.shape[0]
        x_reg = E.new_zeros((P, 0))
        if s.do_apply_regularization:
            rreg = splined_regularization(
                pk["intr_full"][..., 4:].reshape(P, Nci, lm.Ny, lm.Nx, 2),
                *consts.reg_knots)                       # (P, Nci, nterms)
            if not reg_cache:
                # (Nci, nterms, Nip), from the first problem
                Jreg = rows_of.regularization(
                    {k: v[:1] for k, v in pk.items()})[1][0]
                reg_cache.update(J=Jreg, JtJ=torch.einsum(
                    "cki,ckj->cij", Jreg, Jreg).to(hdt))
            E = E + torch.sum(rreg * rreg, dim=(1, 2))
            g_c[:, :cl.e0] += torch.einsum(
                "cki,pck->pci", reg_cache["J"], rreg).reshape(P, -1)
            if Hcc is not None:
                for ci in range(Nci):
                    i0 = cl.coli(ci)
                    Hcc[:, i0:i0 + cl.Nip, i0:i0 + cl.Nip] += \
                        reg_cache["JtJ"][ci]
            x_reg = rreg.reshape(P, -1)
        if (s.do_apply_regularization_unity_cam01
                and s.do_optimize_extrinsics and Nce > 0):
            ru, Ju = rows_of.unity_cam01(pk)             # (P,), (P, 6)
            E = E + ru * ru
            e0 = cl.cole(0)
            g_c[:, e0:e0 + 6] += Ju * ru[:, None]
            if Hcc is not None:
                Hcc[:, e0:e0 + 6, e0:e0 + 6] += \
                    (Ju[:, :, None] * Ju[:, None]).to(hdt)
            x_reg = torch.cat([x_reg, ru[:, None]], dim=1)
        return E, x_reg

    def add_regularization(b, arrays, ne, hessian=True):
        params = split_packed_state(b, arrays, spec, scales=consts.state)
        E, x_reg = add_reg(rows_of.packed(params), ne["E"], ne["g_c"],
                           ne["Hcc"] if hessian else None)
        return dict(ne, E=E, x_reg=x_reg)

    f.add_regularization = add_regularization
    g = _one_or_batch(f)
    g.gradient = lambda b, arrays: g(b, arrays, hessian=False)
    return g


# ----------------------------------------------------------------------------
# Schur-reduced damped step
# ----------------------------------------------------------------------------

def _block_eliminate(A, C, g):
    """Factor the batch of small SPD blocks A (..., n, n) and solve it
    against the coupling block C (..., n, Nc) and the gradient g (..., n),
    in one kernel launch on a CUDA tensor: every leading axis folds into
    the kernel's block axis.  Returns (L, A^-1 C, A^-1 g); L serves the
    back-substitution."""
    n = A.shape[-1]
    rhs = torch.cat([C, g[..., None]], dim=-1)
    L, X = cholesky_factor_solve(A.reshape(-1, n, n),
                                 rhs.reshape(-1, n, rhs.shape[-1]))
    X = X.reshape(rhs.shape)
    return L.reshape(A.shape), X[..., :-1], X[..., -1]


def _back_substitute(L, rhs):
    """Solve the blocks factored by _block_eliminate, L (..., n, n),
    against rhs (..., n), in one kernel launch on a CUDA tensor."""
    n = L.shape[-1]
    return cholesky_solve_factored(L.reshape(-1, n, n),
                                   rhs.reshape(-1, n, 1)).reshape(rhs.shape)


def _per_problem(t, like):
    """t (P,) shaped to broadcast against like (P, ...)."""
    return t.reshape((-1,) + (1,) * (like.dim() - 1))


def _damping_diag(A):
    """Marquardt scaling diagonal for the SPD blocks A (P, ..., n, n) of
    each of P problems: diag(A) clamped below by a relative floor, 1e-12
    of the problem's largest diagonal entry of this block type, so
    barely-observed states still get positive damping."""
    d = torch.diagonal(A, dim1=-2, dim2=-1)
    floor = 1e-12 * torch.amax(d.reshape(d.shape[0], -1), dim=1) + 1e-30
    return torch.maximum(d, _per_problem(floor, d))


def _damped(A, lam, dd):
    """A + lam diag(dd), lam (P,) per problem."""
    n = A.shape[-1]
    return A + (_per_problem(lam, dd) * dd)[..., None] * torch.eye(
        n, dtype=A.dtype, device=A.device)


# the normal-equation entries a step reads
_STEP_KEYS = ("g_c", "g_f", "g_p", "Hcc", "Hff", "Cf", "Hpp", "Cp")


def schur_step(ne, lam, spec: ProblemSpec):
    """Solve (JtJ + lam D) delta = -g exactly via block elimination of
    frame and point blocks, D = Marquardt diag(JtJ) scaling.  Returns
    (delta_c, delta_f, delta_p, pred) where pred is the model's predicted
    decrease of E: pred = -g.d + lam d.D.d.

    ne of one problem (g_c (Nc,)) takes lam a float or a 0-d tensor, and
    is stepped as a batch of one.  ne of P problems (g_c (P, Nc), every
    leaf leading with P) takes lam of shape (P,) or a scalar, and gives
    each output with a leading P: the frame (and point) blocks of all P
    problems go through one fused factor-and-solve launch and one
    back-substitution launch, and the reduced camera systems through one
    batched dense Cholesky, with its failure flag per problem.

    The H and C blocks may be in a lower dtype than the gradient (float32
    H under a float64 gradient): the factorizations and solves then run
    in H's dtype, and delta and pred come back in the gradient's."""
    if ne["g_c"].dim() == 1:
        out = schur_step({k: ne[k][None] for k in _STEP_KEYS},
                         torch.as_tensor(lam, dtype=ne["g_c"].dtype,
                                         device=ne["g_c"].device).reshape(1),
                         spec)
        return tuple(t[0] for t in out)
    dt = ne["g_c"].dtype
    hdt = ne["Hcc"].dtype
    P = ne["g_c"].shape[0]
    lam = torch.as_tensor(lam, dtype=dt, device=ne["g_c"].device).expand(P)
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
        dd_f = _damping_diag(ne["Hff"][:, :Nf])
        Af = _damped(ne["Hff"][:, :Nf], lam_h, dd_f)
        Cf = ne["Cf"][:, :Nf]                              # (P,Nf,6,Nc)
        gf = ne["g_f"][:, :Nf]
        gf_h = gf.to(hdt)
        L_f, AinvC, Ainvg = _block_eliminate(Af, Cf, gf_h)
        H_red = H_red - torch.einsum("pfic,pfid->pcd", Cf, AinvC)
        g_red = g_red - torch.einsum("pfic,pfi->pc", Cf, Ainvg)
    if Npv:
        dd_p = _damping_diag(ne["Hpp"][:, :Npv])
        Ap = _damped(ne["Hpp"][:, :Npv], lam_h, dd_p)
        Cp = ne["Cp"][:, :Npv]
        gp = ne["g_p"][:, :Npv]
        gp_h = gp.to(hdt)
        L_p, AinvCp, Ainvgp = _block_eliminate(Ap, Cp, gp_h)
        H_red = H_red - torch.einsum("pfic,pfid->pcd", Cp, AinvCp)
        g_red = g_red - torch.einsum("pfic,pfi->pc", Cp, Ainvgp)

    # not SPD -> NaN step for that problem (rejected by the LM loop), as
    # LAPACK's potrf leaves it; cholesky_ex does not raise and does not
    # synchronize
    Lc, info = torch.linalg.cholesky_ex(H_red)
    Lc = torch.where((info == 0)[:, None, None], Lc, torch.nan)
    delta_c_h = -torch.cholesky_solve(g_red[..., None], Lc)[..., 0]
    delta_c = delta_c_h.to(dt)

    pred = -torch.sum(ne["g_c"] * delta_c, dim=1) \
        + lam * torch.sum(delta_c * dd_c.to(dt) * delta_c, dim=1)
    delta_f = ne["g_c"].new_zeros((P, max(Nf, 1), 6))
    if Nf:
        rhs = -(gf_h + torch.einsum("pfic,pc->pfi", Cf, delta_c_h))
        delta_f = _back_substitute(L_f, rhs).to(dt)
        pred = pred - torch.sum(gf * delta_f, dim=(1, 2)) \
            + lam * torch.sum(delta_f * (dd_f.to(dt) * delta_f), dim=(1, 2))
    delta_p = ne["g_c"].new_zeros((P, max(Npv, 1), 3))
    if Npv:
        rhs = -(gp_h + torch.einsum("pfic,pc->pfi", Cp, delta_c_h))
        delta_p = _back_substitute(L_p, rhs).to(dt)
        pred = pred - torch.sum(gp * delta_p, dim=(1, 2)) \
            + lam * torch.sum(delta_p * (dd_p.to(dt) * delta_p), dim=(1, 2))
    return delta_c, delta_f, delta_p, pred


def _delta_to_b(delta_c, delta_f, delta_p, spec: ProblemSpec):
    """Map the block step onto the packed state vector layout (with the
    step's leading problem axis, if it has one)."""
    cl = _CLayout(spec)
    lead = tuple(delta_c.shape[:-1])
    parts = []
    if spec.num_states_intrinsics:
        parts.append(delta_c[..., :cl.e0])
    if spec.num_states_extrinsics:
        parts.append(delta_c[..., cl.e0:cl.w0])
    if spec.num_states_frames:
        parts.append(delta_f[..., :spec.Nframes, :].reshape(lead + (-1,)))
    if spec.num_states_points:
        parts.append(delta_p[..., :spec.Npoints_variable, :]
                     .reshape(lead + (-1,)))
    if spec.num_states_calobject_warp:
        parts.append(delta_c[..., cl.w0:cl.w0 + 2])
    if not parts:
        return delta_c[..., :0]
    return torch.cat(parts, dim=-1)


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


def _lm_settings(update_threshold, dtype, quiet, ftol):
    """(effective update threshold, ftol, benchmark mode) of a solve in
    `dtype`."""
    eff_threshold = _effective_threshold(update_threshold, dtype, quiet)
    if ftol is None:
        # f32 grinds at its ~1e-7 relative-E precision floor; f64 at
        # roundoff.  Terminate when accepted improvements fall below it.
        ftol = 1e-5 if dtype == torch.float32 else 1e-6
    # benchmark mode (both thresholds exactly 0): run the full
    # max_iterations, no plateau or trust-region-collapse exits
    return eff_threshold, ftol, eff_threshold <= 0.0 and ftol <= 0.0


def _lm_update(E, E_try, pred, db, lam, nu, E_ref, window, eff_threshold,
               ftol, benchmark):
    """The LM rules of one iteration, the JAX package's device loop's:
    accept, the lambda control, the small-step exit, the 16-iteration
    plateau and lambda > 1e12.  For one problem (E, E_try, pred, lam, nu,
    E_ref 0-d, db (Nstate,)) or each of P (those (P,), db (P, Nstate)).
    window: a host bool, 16 iterations since the plateau's reference.
    Returns (accept, done, lam, nu, E_ref)."""
    rho = torch.where(pred > 0, (E - E_try) / pred, -1.0)
    finite = torch.isfinite(E_try)
    accept = (E_try < E) & finite
    # converged when the proposed step is below the threshold AND
    # non-worsening
    done = (torch.amax(torch.abs(db), dim=-1) < eff_threshold) & \
        (E_try <= E) & finite
    lam_down = torch.clamp_min(
        lam * torch.clamp_min(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0),
        _LAM_FLOOR)
    lam_new = torch.where(accept, torch.where(rho > 0, lam_down, lam / 2.0),
                          lam * nu)
    nu = torch.where(accept, 2.0, nu * 2.0)
    lam = torch.clamp_max(lam_new, 1e20)
    if window:
        # ftol over a WINDOW: 16 iterations with total relative E
        # improvement below 16*ftol -> grinding at the precision floor
        E_now = torch.where(accept, E_try, E)
        if not benchmark:
            done = done | ((E_ref - E_now) <= ftol * 16.0 * E_now)
        E_ref = E_now
    if not benchmark:
        done = done | (lam > 1e12)
    return accept, done, lam, nu, E_ref


def lm_solve(spec: ProblemSpec, arrays, b0, static_idx, *,
             max_iterations=300, update_threshold=1e-7, dtype=None,
             quiet=False, lam0=1e-4, ftol=None, lazy_K=None, h32=False,
             verbose=False):
    """Levenberg-Marquardt to convergence: the rules of _lm_update as one
    Python loop over tensors on the device of `arrays` (_lm_loop).  Each
    iteration reads one scalar (accept and done); verbose also reads and
    prints the iteration's E, trial E, lambda, gain ratio and largest
    step, as the JAX package's host loop prints them.

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
    if lazy_K is None:
        lazy_K = _lazy_h_K(spec, b0.dtype, b0.device)
    ne_fn = build_normal_equations(spec, arrays, static_idx, h32=h32)
    grad_fn = getattr(ne_fn, "gradient", None) or _make_grad_fn(spec)
    return _lm_loop(spec, lambda b: ne_fn(b, arrays),
                    lambda b: grad_fn(b, arrays), b0,
                    max_iterations=max_iterations,
                    update_threshold=update_threshold, quiet=quiet,
                    lam0=lam0, ftol=ftol, lazy_K=lazy_K, verbose=verbose)


def _print_iteration(it, E, E_try, pred, lam, db):
    """The JAX package's verbose line of one LM iteration: one host read
    of its five numbers."""
    rho = torch.where(pred > 0, (E - E_try) / pred, -1.0)
    dbmax = torch.amax(torch.abs(db)) if db.numel() else db.new_zeros(())
    E, E_try, lam, rho, dbmax = torch.stack(
        [t.to(E.dtype) for t in (E, E_try, lam, rho, dbmax)]).tolist()
    print(f"iter {it}: E={E:.6e} Enew={E_try:.6e} lam={lam:.2e} "
          f"rho={rho:.3f} |db|={dbmax:.2e}")


def _lm_loop(spec: ProblemSpec, ne_fn, grad_fn, b0, *, max_iterations,
             update_threshold, quiet, lam0, ftol, lazy_K, verbose=False):
    """The LM loop of one problem around ne_fn(b) -> the normal equations
    and grad_fn(b) -> their _LAZY_H_GRAD_KEYS (the lazy-Hessian mode's
    evaluation on steps that keep H), both at the packed state b.  The
    single-device solve and the sharded one (whose functions reduce over
    the mesh) both run it.  Returns (b, E, niter, ne) as lm_solve."""
    eff_threshold, ftol, benchmark = _lm_settings(update_threshold,
                                                  b0.dtype, quiet, ftol)
    with torch.no_grad():
        b = b0
        ne = ne_fn(b)
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
                ne_try = ne_fn(b_try)
            else:
                ne_try = dict(ne)                  # the stale H blocks
                new = grad_fn(b_try)
                ne_try.update({k: new[k] for k in _LAZY_H_GRAD_KEYS})
            window = it + 1 - it_ref >= 16
            if verbose:
                _print_iteration(it, ne["E"], ne_try["E"], pred, lam, db)
            accept, done, lam, nu, E_ref = _lm_update(
                ne["E"], ne_try["E"], pred, db, lam, nu, E_ref, window,
                eff_threshold, ftol, benchmark)
            if window:
                it_ref = it + 1
            flags = int((accept.to(torch.int32)
                         + 2 * done.to(torch.int32)).item())
            if flags & 1:
                b, ne = b_try, ne_try
                age = 0 if refresh else age + 1
            it += 1
            if flags & 2:
                break
    return b, ne["E"], it, ne


def lm_solve_batch(spec: ProblemSpec, arrays, b0, static_idx, *,
                   max_iterations=300, update_threshold=1e-7, dtype=None,
                   quiet=False, lam0=1e-4, ftol=None, lazy_K=None):
    """lm_solve for P problems of one structure in lockstep, as the JAX
    package's vmap of its device loop runs them: b0 (P, Nstate), every
    float array of `arrays` leading with P, the index arrays shared.

    Every problem keeps its own lambda, nu, plateau reference, done flag
    and iteration count.  The body runs on all P problems; a finished
    problem is frozen (its b, normal equations, lambda and count stop
    changing), and the batch runs until its slowest problem is done or
    max_iterations.  The active problems share one iteration count, so
    the plateau window's position is a host integer.  Each iteration
    reads one small tensor (the done and accept flags).

    lazy_K as lm_solve has it, per problem: each problem counts its own
    accepted steps since its last H refresh.  An iteration where some
    active problem is due evaluates the full normal equations of the
    batch and keeps the stale H of the others; an iteration where none is
    due evaluates the gradient alone.

    Returns (b (P, Nstate), E (P,), niter (P,) int64, ne with a leading P
    on every leaf), tensors on the device."""
    if dtype is not None:
        arrays = _cast_arrays(arrays, dtype)
        b0 = b0.to(dtype)
    if lazy_K is None:
        lazy_K = _lazy_h_K(spec, b0.dtype, b0.device)
    eff_threshold, ftol, benchmark = _lm_settings(update_threshold,
                                                  b0.dtype, quiet, ftol)
    ne_fn = build_normal_equations(spec, arrays, static_idx)
    grad_fn = getattr(ne_fn, "gradient", ne_fn)
    P = b0.shape[0]

    with torch.no_grad():
        b = b0
        ne = ne_fn(b, arrays)
        lam = torch.full((P,), lam0, dtype=b.dtype, device=b.device)
        nu = torch.full((P,), 2.0, dtype=b.dtype, device=b.device)
        E_ref, it_ref = ne["E"], 0
        done = torch.zeros(P, dtype=torch.bool, device=b.device)
        niter = torch.zeros(P, dtype=torch.int64, device=b.device)
        # host copies: the active problems, and each one's accepted steps
        # since its last H refresh
        active_np = np.ones(P, bool)
        age = np.zeros(P, np.int64)
        it = 0
        while it < max_iterations:
            dc, df, dp, pred = schur_step(ne, lam, spec)
            db = _delta_to_b(dc, df, dp, spec)
            b_try = b + db
            refresh_np = age >= lazy_K
            if (refresh_np & active_np).any():
                ne_try = ne_fn(b_try, arrays)
                if not refresh_np.all():
                    keep = torch.as_tensor(~refresh_np, device=b.device)
                    ne_try.update({
                        k: torch.where(_per_problem(keep, v), ne[k], v)
                        for k, v in ne_try.items()
                        if k not in _LAZY_H_GRAD_KEYS})
            else:
                ne_try = dict(ne)                  # the stale H blocks
                new = grad_fn(b_try, arrays)
                ne_try.update({k: new[k] for k in _LAZY_H_GRAD_KEYS})
            window = it + 1 - it_ref >= 16
            accept, stop, lam_new, nu_new, E_ref_new = _lm_update(
                ne["E"], ne_try["E"], pred, db, lam, nu, E_ref, window,
                eff_threshold, ftol, benchmark)
            active = ~done
            accept = accept & active
            b = torch.where(accept[:, None], b_try, b)
            ne = {k: torch.where(_per_problem(accept, v), ne_try[k], v)
                  for k, v in ne.items()}
            lam = torch.where(active, lam_new, lam)
            nu = torch.where(active, nu_new, nu)
            if window:
                E_ref = torch.where(active, E_ref_new, E_ref)
                it_ref = it + 1
            niter = niter + active
            done = done | stop
            it += 1
            done_np, accept_np = torch.stack([done, accept]).cpu().numpy()
            age = np.where(accept_np, np.where(refresh_np, 0, age + 1), age)
            active_np = ~done_np
            if done_np.all():
                break
    return b, ne["E"], niter, ne


def _mark_outliers(spec: ProblemSpec, obs_board_np, x_board,
                   obs_tri_np=None, x_tri=None, px_tri=None, idx_tri=None,
                   extrinsics=None, verbose=False):
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
    obs_board_np and obs_tri_np (weight sign = outlier bit, column 2);
    verbose prints what each pass marks.  Returns (found_new,
    Noutliers_board, Noutliers_triangulated)."""
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
            if verbose:
                print(f"marked {int(np.sum(new_div))} divergent "
                      "triangulated pairs as outliers")
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
        if verbose and np.any(mark):
            print(f"marked {int(np.sum(mark))} new board outliers "
                  f"(total {Nout_b})")
    if have_tri:
        bad_pair = pair_inlier & (xt ** 2 > (k0 * k0) * var)
        if np.any(bad_pair):
            w_t = obs_tri_np[:, 2]
            bad_obs = np.zeros(len(w_t), bool)
            bad_obs[i0[bad_pair]] = True
            bad_obs[i1[bad_pair]] = True
            obs_tri_np[bad_obs & (w_t > 0), 2] *= -1.0
            if verbose:
                print(f"marked {int(np.sum(bad_pair))} new triangulated "
                      "pair outliers")
        w_t = obs_tri_np[:, 2]
        Nout_t = int(np.sum(~((w_t[i0] > 0) & (w_t[i1] > 0))))
    return True, Nout_b, Nout_t


def _fetch_solution_np(b, ne, E):
    """ONE device->host readback of everything optimize() needs on the
    host: packed state, residual vectors, E (as float64 numpy).  For a
    batch (b (P, Nstate)) each leads with P, and E is (P,)."""
    lead = tuple(b.shape[:-1])
    pieces = [t.reshape(lead + (-1,)).to(b.dtype)
              for t in (b, ne["x_board"], ne["x_point"], ne["x_tri"],
                        ne["x_reg"], E)]
    sizes = [int(p.shape[-1]) for p in pieces]
    flat = torch.cat(pieces, dim=-1).cpu().numpy().astype(np.float64)
    out = {}
    off = 0
    for name, n in zip(("b", "x_board", "x_point", "x_tri", "x_reg", "E"),
                       sizes):
        out[name] = flat[..., off:off + n]
        off += n
    out["E"] = out["E"][..., 0] if lead else float(out["E"][0])
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


def _precision(kw):
    precision = kw.get("precision")
    if precision is None:
        mp = kw.get("mixed_precision")
        precision = "f64" if mp is None else ("mixed" if mp else "f64")
    if precision not in ("mixed", "f32", "f64"):
        raise ValueError(f"unknown precision={precision!r}")
    return precision


def _static_idx(kw):
    """Host copies of a problem's board and point index arrays."""
    def idx(name):
        a = kw.get(name)
        return (np.zeros((0, 3), np.int64) if a is None
                else np.asarray(a, np.int64).reshape(-1, 3))
    return dict(board=idx("indices_frame_camintrinsics_camextrinsics"),
                point=idx("indices_point_camintrinsics_camextrinsics"))


def _np_observations(kw):
    """The caller's board and triangulated observation arrays (None where
    a problem has none), which outlier marking mutates in place."""
    obs_b = kw.get("observations_board")
    obs_t = kw.get("observations_point_triangulated")
    return (None if obs_b is None else np.asarray(obs_b),
            None if obs_t is None or not len(obs_t) else np.asarray(obs_t))


def _solver(lm, spec, arrays, static_idx, kw):
    """solve(b, **overrides) -> lm(spec, arrays, b, static_idx, ...) with
    the caller's max_iterations, update_threshold and ftol."""
    max_iterations = int(kw.get("max_iterations", 300))
    update_threshold = float(kw.get("update_threshold", 1e-7))
    ftol = kw.get("ftol")

    def solve(b, **solve_kw):
        solve_kw.setdefault("max_iterations", max_iterations)
        solve_kw.setdefault("update_threshold", update_threshold)
        if ftol is not None:
            solve_kw.setdefault("ftol", ftol)
        # MRCAL_TPU_PROFILE=<logdir> writes a torch.profiler trace per solve
        with profiling.trace():
            return lm(spec, arrays, b, static_idx, **solve_kw)

    return solve


def _solve_in_precision(solve, b, precision, kw, timer):
    """One solve of the outlier loop in `precision`: 'f64', 'f32', or
    'mixed' (an f32 phase to approximate convergence, then an f64 polish).
    solve: a _solver of one problem or of a batch.  Returns (b, E, niter,
    niter_polish, ne)."""
    if precision == "f32":
        with timer.phase("solve_f32"):
            b, E, niter, ne = solve(b, dtype=torch.float32, quiet=True)
        return b, E, niter, 0, ne
    if precision == "mixed":
        f32_kw = ({} if kw.get("ftol_f32") is None
                  else dict(ftol=float(kw["ftol_f32"])))
        with timer.phase("solve_f32"):
            b32, _, niter32, _ = solve(b, dtype=torch.float32, quiet=True,
                                       **f32_kw)
        with timer.phase("solve_polish_f64"):
            b, E, niter, ne = solve(b32.to(torch.float64),
                                    max_iterations=300)
        return b, E, niter + niter32, niter, ne
    with timer.phase("solve_f64"):
        b, E, niter, ne = solve(b)
    return b, E, niter, 0, ne


def _upload(arrays, name, a):
    """Replace arrays[name] by the numpy array a (the outlier marks)."""
    arrays[name] = torch.as_tensor(a, dtype=arrays[name].dtype,
                                   device=arrays[name].device)


def _write_back(kw, spec: ProblemSpec, blocks_np):
    """Write a solution into the caller's numpy arrays (only the OPTIMIZED
    slices)."""
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


def _stats(spec: ProblemSpec, sol, Noutliers, Noutliers_tri, niter,
           niter_polish, time_s):
    """optimize()'s stats dict from one problem's fetched solution."""
    return dict(
        rms_reproj_error__pixels=float(
            np.sqrt(float(sol["E"]) / max(spec.Nmeasurements, 1))),
        Noutliers=Noutliers,
        Noutliers_board=Noutliers,
        Noutliers_triangulated_point=Noutliers_tri,
        niterations=niter,
        niterations_polish=niter_polish,
        time_s=time_s,
        b_packed=sol["b"],
        x=np.concatenate([sol["x_board"], sol["x_point"], sol["x_tri"],
                          sol["x_reg"]]),
    )


def optimize(*, device=None, **kw):
    """Full solve: the mrcal.optimize equivalent.

    device: where the solve runs; None means the CUDA card (and raises
    without one), "cpu" runs on the CPU.  precision: 'f64' (default),
    'f32', or 'mixed' (f32 phase to approximate convergence, then an f64
    polish).

    verbose=True prints a line per LM iteration (not on a mesh) and per
    outlier pass that marks something, and a line per column checked with
    check_gradient=True, as the JAX package prints them.

    mesh: a mrcal_tpu_torch.parallel mesh, an int or "auto" (make_mesh of
    the torch.distributed default group, on `device`: None means each
    rank's card) shards the observations over the group's ranks
    (sharded_lm_solve_device); every rank calls optimize() with the same
    inputs and gets the same solution and stats (time_s is its own).

    device_loop: the JAX package's choice between its device-resident
    and its host LM loop, which run the same LM rules; the port has one
    loop, which serves either value.

    Mutates the input numpy arrays (intrinsics, extrinsics_rt_fromref,
    frames_rt_toref, points, calobject_warp, and observation weights for
    outlier marking) like the reference does, and returns a stats dict.
    check_gradient=True compares the Jacobian with central differences
    instead, and returns that report without solving."""
    mesh = kw.pop("mesh", None)
    verbose = bool(kw.get("verbose", False))

    def lm(*args, **solve_kw):
        return lm_solve(*args, verbose=verbose, **solve_kw)

    if mesh is not None:
        from ..parallel.sharding import (Mesh, make_mesh,
                                         sharded_lm_solve_device)
        if not isinstance(mesh, Mesh):
            mesh = make_mesh(mesh, device=device)
        device = mesh.device

        def lm(spec, arrays, b, static_idx, **solve_kw):
            return sharded_lm_solve_device(spec, arrays, b, mesh,
                                           **solve_kw)
    device = resolve_device(device)
    timer = profiling._SolveTimer()
    kw = _layout.normalize_inputs(kw)
    spec = spec_from_inputs(**kw)

    # the caller's arrays, mutated in place by outlier marking
    np_obs_board, np_obs_tri = _np_observations(kw)

    with timer.phase("pack"):
        arrays = arrays_from_inputs(kw, device=device, dtype=DEFAULT_DTYPE)
        b = pack_params(params_from_arrays(arrays), spec)
    static_idx = _static_idx(kw)

    if kw.get("check_gradient"):
        # the reference's semantics: check the Jacobian column by column
        # against finite differences, and return without solving
        from .jacobian import _check_gradient_report
        return _check_gradient_report(spec, arrays, b, verbose=verbose)

    precision = _precision(kw)
    solve = _solver(lm, spec, arrays, static_idx, kw)
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
        b, E, niter, polish, ne = _solve_in_precision(solve, b, precision,
                                                      kw, timer)
        total_niter += niter
        niter_polish += polish
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
                                         kw.get("extrinsics_rt_fromref")),
                verbose=verbose)
        if not found:
            break
        for name, a in (("observations_board", np_obs_board),
                        ("observations_point_triangulated", np_obs_tri)):
            if a is not None:
                _upload(arrays, name, a)

    _write_back(kw, spec, blocks_np)
    return _stats(spec, sol, Noutliers, Noutliers_tri, total_niter,
                  niter_polish, {k: round(v, 6) for k, v in timer.t.items()})


# ----------------------------------------------------------------------------
# batched solves: many same-structure problems in lockstep
# ----------------------------------------------------------------------------

def _stack_arrays(arrays_list):
    """The arrays of P problems of one structure as one batch: the float
    arrays stacked on a leading P axis, the index arrays the first
    problem's."""
    return {k: (torch.stack([a[k] for a in arrays_list])
                if v.is_floating_point() else v)
            for k, v in arrays_list[0].items()}


def optimize_batch(problems, *, device=None, **common_kw):
    """Solve many calibration problems of one structure as one batch, the
    JAX package's serving mode: their LM loops run in lockstep (finished
    problems freeze while the rest iterate), each iteration's work on all
    problems at once, so a batch of P takes about the launches of one
    problem.

    problems: a list of mrcal-style optimization_inputs dicts that share
    the lens model, the counts and the board and point index arrays (a
    fleet of calibrations from one rig design; see
    pad_problems_to_common_structure for units that see different
    views); the float inputs differ per problem.  common_kw:
    max_iterations, update_threshold, ftol, precision ('f64' (default),
    'f32' or 'mixed', as optimize()).  device: None means the CUDA card,
    "cpu" the CPU.

    Like optimize(), MUTATES each problem's arrays with its solution and
    runs the outlier-rejection loop: each problem is marked on the host,
    and when any problem found outliers the whole batch is solved again
    from its current solutions.  Returns a list of per-problem stats with
    optimize()'s keys; time_s is the batch's, and Noutliers counts every
    observation of weight <= 0, padding rows included.  Splined models
    with the core locked take the spline-window assembly with a problem
    axis, and their f32 phase on the card the lazy Hessian per
    problem."""
    if not problems:
        return []
    kws = [_layout.normalize_inputs(dict(p)) for p in problems]
    specs = [spec_from_inputs(**kw) for kw in kws]
    spec = specs[0]
    if any(s != spec for s in specs[1:]):
        raise ValueError("optimize_batch needs identical problem "
                         "structure across the batch")
    static_idx = _static_idx(kws[0])
    for kw in kws[1:]:
        for k, v in _static_idx(kw).items():
            if not np.array_equal(v, static_idx[k]):
                raise ValueError(f"optimize_batch needs identical {k} "
                                 "indices across the batch")
    device = resolve_device(device)
    precision = _precision(common_kw)
    timer = profiling._SolveTimer()
    P = len(kws)
    np_obs = [_np_observations(kw) for kw in kws]

    with timer.phase("pack"):
        arrays = _stack_arrays([arrays_from_inputs(kw, device=device)
                                for kw in kws])
        b = pack_params(params_from_arrays(arrays), spec)
    solve = _solver(lm_solve_batch, spec, arrays, static_idx, common_kw)
    total_niter = np.zeros(P, np.int64)
    niter_polish = np.zeros(P, np.int64)
    Nout_tri = np.zeros(P, np.int64)
    have_tri = np_obs[0][1] is not None
    outlier_loop = spec.selections.do_apply_outlier_rejection and (
        spec.Nobservations_board or have_tri)
    if outlier_loop and have_tri:
        px_tri_np = arrays["px_triangulated"].cpu().numpy()
        idx_tri_np = arrays["indices_triangulated"].cpu().numpy()
    while True:
        b, E, niter, polish, ne = _solve_in_precision(
            solve, b, precision, common_kw, timer)
        with timer.phase("fetch"):
            sol = _fetch_solution_np(b, ne, E)
            total_niter += niter.cpu().numpy()
            if torch.is_tensor(polish):
                niter_polish += polish.cpu().numpy()
        blocks_np = [_unpack_state_np(sol["b"][i], spec) for i in range(P)]
        if not outlier_loop:
            break
        found_any = False
        with timer.phase("outlier_rejection"):
            for i, (obs_b, obs_t) in enumerate(np_obs):
                found, _, Nout_tri[i] = _mark_outliers(
                    spec, obs_b, sol["x_board"][i], obs_tri_np=obs_t,
                    x_tri=sol["x_tri"][i],
                    px_tri=px_tri_np[i] if have_tri else None,
                    idx_tri=idx_tri_np if have_tri else None,
                    extrinsics=blocks_np[i].get(
                        "extrinsics", kws[i].get("extrinsics_rt_fromref")))
                found_any |= found
        if not found_any:
            break
        for j, name in enumerate(("observations_board",
                                  "observations_point_triangulated")):
            if np_obs[0][j] is not None:
                _upload(arrays, name, np.stack([o[j] for o in np_obs]))

    time_s = {k: round(v, 6) for k, v in timer.t.items()}
    stats = []
    for i, (kw, (obs_b, _)) in enumerate(zip(kws, np_obs)):
        _write_back(kw, spec, blocks_np[i])
        Nout = int(np.sum(obs_b[..., 2] <= 0)) if obs_b is not None else 0
        stats.append(_stats(spec, {k: v[i] for k, v in sol.items()}, Nout,
                            int(Nout_tri[i]), int(total_niter[i]),
                            int(niter_polish[i]), dict(time_s)))
    return stats


def pad_problems_to_common_structure(problems):
    """Make a HETEROGENEOUS fleet batchable by optimize_batch.

    optimize_batch requires identical observation-index structure across
    the batch.  Real fleets share a rig DESIGN (same cameras, frames,
    lensmodel) but differ in per-unit visibility: some units miss some
    board views or point observations.  This builds the UNION of the
    board/point index rows across the batch and returns adjusted copies
    of the problems where every unit carries the same index arrays; rows
    a unit lacks are padded with weight=-1 observations (the outlier
    idiom: weight<=0 zeroes the residual AND the Jacobian rows, so
    padding contributes nothing to the solve).

    Padding rows count as outliers in the returned stats' Noutliers
    (weight<=0); subtract the per-unit pad count if the distinction
    matters.  Triangulated-point sets are not padded (their set/last
    structure is positional): problems carrying DIFFERING triangulated
    sets raise.

    Returns a new list of optimization_inputs dicts (inputs unchanged;
    observation arrays are fresh copies, other arrays shared)."""
    kws = [_layout.normalize_inputs(dict(p)) for p in problems]

    tri0 = kws[0].get(
        "indices_point_triangulated_camintrinsics_camextrinsics")
    for kw in kws[1:]:
        t = kw.get(
            "indices_point_triangulated_camintrinsics_camextrinsics")
        if (t is None) != (tri0 is None) or \
                (t is not None and not np.array_equal(
                    np.asarray(t), np.asarray(tri0))):
            raise ValueError("pad_problems_to_common_structure: "
                             "triangulated-point sets must already be "
                             "identical across the batch")

    def union_rows(key):
        rows = set()
        for kw in kws:
            idx = kw.get(key)
            if idx is not None:
                rows.update(map(tuple, np.asarray(idx, np.int32)))
        return np.asarray(sorted(rows), np.int32).reshape(-1, 3) \
            if rows else None

    ub = union_rows("indices_frame_camintrinsics_camextrinsics")
    up = union_rows("indices_point_camintrinsics_camextrinsics")

    out = []
    for kw in kws:
        kw = dict(kw)
        if ub is not None:
            obs = kw.get("observations_board")
            if obs is None:
                raise ValueError("board indices without observations")
            new = np.zeros((len(ub),) + np.asarray(obs).shape[1:])
            new[..., 2] = -1.0                     # padding = outlier
            pos = {tuple(r): i for i, r in enumerate(
                np.asarray(kw["indices_frame_camintrinsics_"
                              "camextrinsics"], np.int32))}
            for j, r in enumerate(map(tuple, ub)):
                if r in pos:
                    new[j] = np.asarray(obs)[pos[r]]
            kw["observations_board"] = new
            kw["indices_frame_camintrinsics_camextrinsics"] = ub.copy()
        if up is not None:
            obs = kw.get("observations_point")
            new = np.zeros((len(up), 3))
            new[:, 2] = -1.0
            if obs is not None:
                pos = {tuple(r): i for i, r in enumerate(
                    np.asarray(kw["indices_point_camintrinsics_"
                                  "camextrinsics"], np.int32))}
                for j, r in enumerate(map(tuple, up)):
                    if r in pos:
                        new[j] = np.asarray(obs)[pos[r]]
            kw["observations_point"] = new
            kw["indices_point_camintrinsics_camextrinsics"] = up.copy()
        out.append(kw)
    return out
