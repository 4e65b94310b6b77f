"""The residual vector of a calibration problem, as functions of tensors.

Counterpart of ``mrcal_tpu/optimize/residuals.py`` for boards, discrete
points, triangulated points and the parametric and splined
regularization, and of its cross-reprojection machinery
(``residuals_cross``, ``drt_cross_reprojection__dbpacked``).  Reference
semantics:

  - board: 2 weighted-pixel-error measurements per corner; weight < 0 marks
    an outlier -> 0 residual, 0 gradient
  - point: 2 measurements; weight <= 0 -> outlier
  - triangulated point: 1 scalar ray-divergence measurement per pair of
    observations of one point; either weight <= 0 -> 0
  - measurement order: boards -> points -> triangulated -> regularization
  - board geometry: grid spacing*(x,y), z = warp_x*4 xr(1-xr) + warp_y*4
    yr(1-yr), xr=x/(W-1)
  - joint transform: rt_cam_ref compose rt_ref_frame

Everything is vectorized over observations (gather + broadcast).
"""

import numpy as np
import torch

from .._config import DEFAULT_DTYPE, resolve_device
from ..lensmodels import project_core, unproject_core
from ..poseutils import (_compose_rt2, _invert_rt, _rotate_point_r,
                         _transform_point_rt)
from ..triangulation import _triangulated_error
from .layout import (ProblemSpec, normalize_inputs, spec_from_inputs,
                     triangulated_pair_indices)


# ----------------------------------------------------------------------------
# inputs
# ----------------------------------------------------------------------------

def arrays_from_inputs(optimization_inputs, *, device, dtype=DEFAULT_DTYPE):
    """The dynamic arrays of mrcal-style optimization_inputs as tensors on
    `device`: floats in `dtype`, index arrays as int64.  The triangulated
    observations are also unprojected, with the fixed intrinsics, into
    unit direction vectors (px_triangulated): triangulated solves do not
    optimize the intrinsics."""
    kw = normalize_inputs(optimization_inputs)

    def arr(name, shape_tail):
        a = kw.get(name)
        if a is None:
            return torch.zeros((0,) + shape_tail, dtype=dtype, device=device)
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def idx(name):
        a = kw.get(name)
        if a is None:
            return torch.zeros((0, 3), dtype=torch.int64, device=device)
        return torch.as_tensor(np.asarray(a).reshape(-1, 3),
                               dtype=torch.int64, device=device)

    warp = kw.get("calobject_warp")
    out = dict(
        intrinsics=arr("intrinsics", (0,)),
        extrinsics=arr("extrinsics_rt_fromref", (6,)),
        frames=arr("frames_rt_toref", (6,)),
        points=arr("points", (3,)),
        calobject_warp=(torch.zeros(2, dtype=dtype, device=device)
                        if warp is None else
                        torch.as_tensor(np.asarray(warp), dtype=dtype,
                                        device=device)),
        observations_board=arr("observations_board", (0, 0, 3)),
        indices_board=idx("indices_frame_camintrinsics_camextrinsics"),
        observations_point=arr("observations_point", (3,)),
        indices_point=idx("indices_point_camintrinsics_camextrinsics"),
        observations_point_triangulated=arr(
            "observations_point_triangulated", (3,)),
        indices_triangulated=idx(
            "indices_point_triangulated_camintrinsics_camextrinsics"),
    )
    obs_tri = out["observations_point_triangulated"]
    if obs_tri.shape[0]:
        ici = out["indices_triangulated"][:, 1]
        v = unproject_core(obs_tri[:, :2], out["intrinsics"][ici],
                           kw["lensmodel"])
        out["px_triangulated"] = \
            v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    else:
        out["px_triangulated"] = torch.zeros((0, 3), dtype=dtype,
                                             device=device)
    return out


def params_from_arrays(arrays):
    """The optimizable parameters, in real (unpacked) units."""
    return dict(intrinsics=arrays["intrinsics"],
                extrinsics=arrays["extrinsics"],
                frames=arrays["frames"],
                points=arrays["points"],
                calobject_warp=arrays["calobject_warp"])


# ----------------------------------------------------------------------------
# board geometry
# ----------------------------------------------------------------------------

def board_points_ref(spec: ProblemSpec, calobject_warp, dtype=None):
    """Calibration-object grid in board coords, with parabolic warp.
    -> (H, W, 3)"""
    H = spec.calibration_object_height_n
    W = spec.calibration_object_width_n
    dtype = dtype or calobject_warp.dtype
    dev = calobject_warp.device
    y = torch.arange(H, dtype=dtype, device=dev)
    x = torch.arange(W, dtype=dtype, device=dev)
    xg, yg = torch.meshgrid(x, y, indexing="xy")          # (H,W)
    xr = xg / (W - 1)
    yr = yg / (H - 1)
    z = (calobject_warp[0] * 4.0 * xr * (1.0 - xr) +
         calobject_warp[1] * 4.0 * yr * (1.0 - yr))
    s = spec.calibration_object_spacing
    return torch.stack([xg * s, yg * s, z], dim=-1)


# ----------------------------------------------------------------------------
# residual blocks
# ----------------------------------------------------------------------------

def _ext_padded(extrinsics):
    """Prepend an identity row so icam_extrinsics=-1 (camera at the
    reference) indexes row 0 with no branching."""
    return torch.cat([extrinsics.new_zeros((1, 6)), extrinsics], dim=0)


def residuals_board(params, arrays, spec: ProblemSpec):
    """Weighted board reprojection residuals -> (Nobs, H, W, 2)."""
    if spec.Nobservations_board == 0:
        return params["intrinsics"].new_zeros((0,))
    obs = arrays["observations_board"]                    # (Nobs,H,W,3)
    idx = arrays["indices_board"]                         # (Nobs,3)
    iframe, ici, ice = idx[:, 0], idx[:, 1], idx[:, 2]

    rt_cam_ref = _ext_padded(params["extrinsics"])[ice + 1]   # (Nobs,6)
    rt_ref_frame = params["frames"][iframe]                   # (Nobs,6)
    rt_joint = _compose_rt2(rt_cam_ref, rt_ref_frame)         # (Nobs,6)

    pts = board_points_ref(spec, params["calobject_warp"])    # (H,W,3)
    p_cam = _transform_point_rt(rt_joint[:, None, None, :], pts[None])
    intr = params["intrinsics"][ici][:, None, None, :]        # (Nobs,1,1,Ni)
    q = project_core(p_cam, intr, spec.lensmodel)             # (Nobs,H,W,2)

    factor = torch.clamp_min(obs[..., 2], 0.0)  # weight<0 -> outlier -> 0
    return (q - obs[..., :2]) * factor[..., None]


def residuals_point(params, arrays, spec: ProblemSpec):
    """Point-observation residuals -> (Nobs_point, 2)."""
    if spec.Nobservations_point == 0:
        return params["intrinsics"].new_zeros((0, 2))
    obs = arrays["observations_point"]                    # (Nobs,3) qx qy w
    idx = arrays["indices_point"]
    ipt, ici, ice = idx[:, 0], idx[:, 1], idx[:, 2]

    p_ref = params["points"][ipt]                         # (Nobs,3)
    rt_cam_ref = _ext_padded(params["extrinsics"])[ice + 1]
    p_cam = _transform_point_rt(rt_cam_ref, p_ref)
    q = project_core(p_cam, params["intrinsics"][ici], spec.lensmodel)

    w = obs[..., 2]
    factor = torch.where(w > 0.0, w, 0.0)   # weight<=0 -> outlier
    return (q - obs[..., :2]) * factor[..., None]


def distortion_regularization_scales(spec: ProblemSpec):
    """Per-distortion regularization scale of the parametric models: the
    rational-denominator coefficients k4,k5,k6 are regularized 5x harder."""
    scale = 0.1                                  # nominal pixel error
    sh = np.full(spec.Ndistortions, scale)
    if (spec.lensmodel.family.startswith("LENSMODEL_OPENCV")
            and spec.Nintrinsics >= 12):
        sh[5:8] = scale * 5.0
    return sh


# splined regularization: the nominal pixel error over this many pixels
SPLINED_REGULARIZATION_SCALE = 0.1 / 10.0


def knot_direction_weights(spec: ProblemSpec):
    """Per-knot radial unit vector (ux, uy) and tangential weight of the
    splined regularization, (Ny, Nx) numpy arrays each: the radial
    direction from the grid's center, (1, 0) at the center knot, whose
    tangential weight is 1 (10 elsewhere)."""
    Nx, Ny = spec.lensmodel.Nx, spec.lensmodel.Ny
    ix, iy = np.meshgrid(np.arange(Nx), np.arange(Ny))
    ux = (2 * ix - Nx + 1).astype(np.float64)
    uy = (2 * iy - Ny + 1).astype(np.float64)
    center = (ux == 0) & (uy == 0)
    mag = np.sqrt(ux * ux + uy * uy)
    mag[center] = 1.0
    ux = ux / mag
    uy = uy / mag
    ux[center] = 1.0
    uy[center] = 0.0
    extra = np.where(center, 1.0, 10.0)
    return ux, uy, extra


def splined_regularization(du, ux, uy, extra):
    """The splined regularization rows of control points du (..., Ny, Nx,
    2): per knot, row-major over (iy, ix), its radial then its tangential
    component, scaled -> (..., 2 Ny Nx)."""
    scale = SPLINED_REGULARIZATION_SCALE
    err_rad = scale * (du[..., 0] * ux + du[..., 1] * uy)
    err_tan = scale * extra * (du[..., 0] * uy - du[..., 1] * ux)
    return torch.stack([err_rad, err_tan], dim=-1).reshape(
        du.shape[:-3] + (-1,))


def residuals_regularization(params, arrays, spec: ProblemSpec):
    """Regularization measurements -> (Nreg,)."""
    s = spec.selections
    intr = params["intrinsics"]
    dt, dev = intr.dtype, intr.device
    nominal_pixel_error = 0.1
    parts = []

    if s.do_apply_regularization and s.do_optimize_intrinsics_distortions \
            and spec.Ndistortions > 0:
        if spec.is_splined:
            lm = spec.lensmodel
            du = intr[:, 4:].reshape(-1, lm.Ny, lm.Nx, 2)
            w = (torch.as_tensor(a, dtype=dt, device=dev)
                 for a in knot_direction_weights(spec))
            parts.append(splined_regularization(du, *w).reshape(-1))
        else:
            sh = torch.as_tensor(distortion_regularization_scales(spec),
                                 dtype=dt, device=dev)
            parts.append((intr[:, spec.Ncore:] * sh).reshape(-1))

    if s.do_apply_regularization and spec.has_core \
            and s.do_optimize_intrinsics_core:
        # the reference scales by camera 0's width for ALL cameras, but
        # targets the center of each camera
        W0 = spec.imagersizes[0][0]
        scale = nominal_pixel_error / (W0 * 0.1)
        targets = np.asarray([((w - 1) * 0.5, (h - 1) * 0.5)
                              for w, h in spec.imagersizes], dtype=np.float64)
        cxy = intr[:, 2:4]
        parts.append((scale * (cxy - torch.as_tensor(targets, dtype=dt,
                                                     device=dev))).reshape(-1))

    if (s.do_apply_regularization_unity_cam01 and s.do_optimize_extrinsics
            and spec.Ncameras_extrinsics > 0):
        scale = nominal_pixel_error / 0.01
        t0 = params["extrinsics"][0, 3:]
        parts.append((scale * (torch.sum(t0 * t0) - 1.0))[None])

    if not parts:
        return intr.new_zeros((0,))
    return torch.cat(parts)


def triangulated_pair_geometry(rt_0r, rt_1r, v0):
    """A pair's observation-0 ray and baseline in camera-1 coordinates:
    (v0 in camera 1, camera-0 origin in camera 1), from the two cameras'
    rt_cam_ref."""
    v0_ref = _rotate_point_r(rt_0r[..., :3], v0, inverted=True)
    t_r0 = -_rotate_point_r(rt_0r[..., :3], rt_0r[..., 3:], inverted=True)
    v0_cam1 = _rotate_point_r(rt_1r[..., :3], v0_ref)
    t_10 = _rotate_point_r(rt_1r[..., :3], t_r0) + rt_1r[..., 3:]
    return v0_cam1, t_10


def residuals_triangulated(params, arrays, spec: ProblemSpec):
    """Triangulated-point pairwise ray-divergence measurements: one scalar
    per pair of observations within each set, from the pre-unprojected
    directions px_triangulated -> (Npairs,)."""
    if not spec.num_measurements_points_triangulated:
        return params["intrinsics"].new_zeros((0,))
    px = arrays["px_triangulated"]
    ice = arrays["indices_triangulated"][:, 2]
    w = arrays["observations_point_triangulated"][:, 2]
    i0, i1 = (torch.as_tensor(a, device=px.device) for a in
              triangulated_pair_indices(spec.triangulated_set_sizes))
    ext_pad = _ext_padded(params["extrinsics"])
    v0_cam1, t_10 = triangulated_pair_geometry(
        ext_pad[ice[i0] + 1], ext_pad[ice[i1] + 1], px[i0])
    err = _triangulated_error(px[i1], v0_cam1, t_10)
    # either observation marked outlier (weight<=0) kills the measurement
    valid = (w[i0] > 0) & (w[i1] > 0)
    return torch.where(valid, err, 0.0)


def residuals_full(params, arrays, spec: ProblemSpec):
    """The complete measurement vector x, in the reference's order
    (boards -> points -> triangulated -> regularization)."""
    xb = residuals_board(params, arrays, spec).reshape(-1)
    xp = residuals_point(params, arrays, spec).reshape(-1)
    xt = residuals_triangulated(params, arrays, spec)
    xr = residuals_regularization(params, arrays, spec)
    return torch.cat([xb, xp, xt, xr])


# ----------------------------------------------------------------------------
# packed-state interface
# ----------------------------------------------------------------------------

def split_packed_state(b, arrays, spec: ProblemSpec, scales=None):
    """Unpack a packed state vector b into the full parameter dict,
    filling non-optimized parts from `arrays`.  `scales`: spec.scales() as
    a tensor like b, to spare a host-to-device copy per call.

    b may lead with a problem axis, (P, Nstate), and then so does every
    float array of `arrays`, and every parameter returned."""
    if scales is None:
        scales = torch.as_tensor(spec.scales(), dtype=b.dtype,
                                 device=b.device)
    bu = b * scales
    lead = tuple(b.shape[:-1])
    s = spec.selections
    params = dict(params_from_arrays(arrays))

    i = 0
    n = spec.num_states_intrinsics
    if n:
        per = spec.Nintrinsics_state_per_cam
        blk = bu[..., i:i + n].reshape(lead + (spec.Ncameras_intrinsics,
                                              per))
        intr = params["intrinsics"]
        j = 0
        if spec.Ncore_state:
            intr = torch.cat([blk[..., :4], intr[..., 4:]], dim=-1)
            j = 4
        if s.do_optimize_intrinsics_distortions:
            intr = torch.cat([intr[..., :spec.Ncore], blk[..., j:]], dim=-1)
        params["intrinsics"] = intr
        i += n
    n = spec.num_states_extrinsics
    if n:
        params["extrinsics"] = bu[..., i:i + n].reshape(lead + (-1, 6))
        i += n
    n = spec.num_states_frames
    if n:
        params["frames"] = bu[..., i:i + n].reshape(lead + (-1, 6))
        i += n
    n = spec.num_states_points
    if n:
        pts = bu[..., i:i + n].reshape(lead + (-1, 3))
        params["points"] = torch.cat(
            [pts, params["points"][..., spec.Npoints_variable:, :]],
            dim=-2) if spec.Npoints_fixed else pts
        i += n
    if spec.num_states_calobject_warp:
        params["calobject_warp"] = bu[..., i:i + 2]
        i += 2
    if i != spec.Nstate:
        raise ValueError(f"packed state has {i} entries, expected "
                         f"{spec.Nstate}")
    return params


def pack_params(params, spec: ProblemSpec):
    """Extract the packed state vector from a parameter dict.  Parameters
    that lead with a problem axis P give b of shape (P, Nstate)."""
    s = spec.selections
    intr = params["intrinsics"]
    lead = tuple(intr.shape[:-2])
    parts = []
    if spec.num_states_intrinsics:
        cols = []
        if spec.Ncore_state:
            cols.append(intr[..., :4])
        if s.do_optimize_intrinsics_distortions:
            cols.append(intr[..., spec.Ncore:])
        parts.append(torch.cat(cols, dim=-1).reshape(lead + (-1,)))
    if spec.num_states_extrinsics:
        parts.append(params["extrinsics"].reshape(lead + (-1,)))
    if spec.num_states_frames:
        parts.append(params["frames"].reshape(lead + (-1,)))
    if spec.num_states_points:
        parts.append(params["points"][..., :spec.Npoints_variable, :]
                     .reshape(lead + (-1,)))
    if spec.num_states_calobject_warp:
        parts.append(params["calobject_warp"])
    b = torch.cat(parts, dim=-1) if parts else intr.new_zeros(lead + (0,))
    return b / torch.as_tensor(spec.scales(), dtype=b.dtype, device=b.device)


def residuals_from_packed(b, arrays, spec: ProblemSpec):
    return residuals_full(split_packed_state(b, arrays, spec), arrays, spec)


# ----------------------------------------------------------------------------
# cross-reprojection
# ----------------------------------------------------------------------------

def residuals_cross(rt_cc, b, arrays, spec: ProblemSpec,
                    rt_cam_star_ref=None, ccp_per_observation=False):
    """The boards' and points' measurement rows with a rigid perturbation
    of the reference inserted between every camera and frame transform.

    Flavors:
      - 'ccp' stationary (rt_cam_star_ref given): rt_ref_ref* is rt_cc
        (= rt_cam*_cam*) conjugated by the query camera's one extrinsics;
      - 'ccp' general (ccp_per_observation=True): each observation row
        conjugates rt_cc by its own extrinsics, which handles a moving
        camera (one camera observed under several extrinsics); for a
        stationary camera the query camera's rows reduce to the
        conjugate form;
      - 'rrp' (neither given): rt_cc is rt_ref_ref* itself."""
    params = split_packed_state(b, arrays, spec)
    if not ccp_per_observation:
        rt_ref_refp = rt_cc if rt_cam_star_ref is None else _compose_rt2(
            _invert_rt(rt_cam_star_ref), _compose_rt2(rt_cc, rt_cam_star_ref))

    def rt_rr_rows(rt_cam_ref_rows):
        """Per row rt_ref_ref*: rt_cc conjugated by the row's own
        extrinsics in the per-observation flavor (identity conjugation
        for rows of the camera at the reference)."""
        if not ccp_per_observation:
            return rt_ref_refp.expand(rt_cam_ref_rows.shape)
        return _compose_rt2(_invert_rt(rt_cam_ref_rows),
                            _compose_rt2(rt_cc.expand(rt_cam_ref_rows.shape),
                                         rt_cam_ref_rows))

    ext_pad = _ext_padded(params["extrinsics"])
    parts = []
    if spec.Nobservations_board:
        obs = arrays["observations_board"]
        idx = arrays["indices_board"]
        iframe, ici, ice = idx[:, 0], idx[:, 1], idx[:, 2]
        rt_cam_ref = ext_pad[ice + 1]
        rt_ref_frame = _compose_rt2(rt_rr_rows(rt_cam_ref),
                                    params["frames"][iframe])
        rt_joint = _compose_rt2(rt_cam_ref, rt_ref_frame)
        pts = board_points_ref(spec, params["calobject_warp"])
        p_cam = _transform_point_rt(rt_joint[:, None, None, :], pts[None])
        q = project_core(p_cam, params["intrinsics"][ici][:, None, None, :],
                         spec.lensmodel)
        w = torch.clamp_min(obs[..., 2], 0.0)
        parts.append(((q - obs[..., :2]) * w[..., None]).reshape(-1))
    if spec.Nobservations_point:
        obs = arrays["observations_point"]
        idx = arrays["indices_point"]
        ipt, ici, ice = idx[:, 0], idx[:, 1], idx[:, 2]
        rt_cam_ref = ext_pad[ice + 1]
        p_ref = _transform_point_rt(rt_rr_rows(rt_cam_ref),
                                    params["points"][ipt])
        p_cam = _transform_point_rt(rt_cam_ref, p_ref)
        q = project_core(p_cam, params["intrinsics"][ici], spec.lensmodel)
        w = torch.where(obs[..., 2] > 0.0, obs[..., 2], 0.0)
        parts.append(((q - obs[..., :2]) * w[..., None]).reshape(-1))
    if not parts:
        return b.new_zeros((0,))
    return torch.cat(parts)


def _drt_cross(spec: ProblemSpec, arrays, b, icam_intrinsics, coo=None):
    """Kpacked (6, Nstate), a tensor like b: see
    drt_cross_reprojection__dbpacked.  coo: the measurement Jacobian's
    triplets (jacobian._jacobian_coo) at b, if the caller has them."""
    from ..factorization import _cholesky_factor_of_JtJ
    from .jacobian import _jacobian_coo
    ccp = icam_intrinsics is not None and icam_intrinsics >= 0
    Jcross = torch.func.jacfwd(
        lambda rt: residuals_cross(rt, b, arrays, spec,
                                   ccp_per_observation=ccp))(
        b.new_zeros(6))                                # (Nmeas_obs, 6)
    if ccp:
        # the ccp fit takes the query camera's rows only.  Masking Jcross
        # masks both Jc^T Jc and Jc^T J (the mask is idempotent)
        masks = []
        if spec.Nobservations_board:
            masks.append((arrays["indices_board"][:, 1] == icam_intrinsics)
                         .repeat_interleave(
                             2 * spec.calibration_object_height_n
                             * spec.calibration_object_width_n))
        if spec.Nobservations_point:
            masks.append((arrays["indices_point"][:, 1] == icam_intrinsics)
                         .repeat_interleave(2))
        if masks:
            Jcross = Jcross * torch.cat(masks)[:, None]

    # Jc^T J over the perturbed quantities of the cross-reprojection flow:
    # frames, points and the warp (rrp); the extrinsics too (ccp)
    rows, cols, vals = coo if coo is not None else _jacobian_coo(b, arrays,
                                                                 spec)
    Jc_rows = torch.cat([Jcross, Jcross.new_zeros(
        (spec.Nmeasurements - Jcross.shape[0], 6))])[rows]
    JcT_J = b.new_zeros((spec.Nstate, 6)).index_add_(
        0, cols, vals[:, None] * Jc_rows).T.contiguous()
    JcT_J[:, :(spec.state_index_extrinsics0 if ccp
               else spec.state_index_frames0)] = 0.0
    L = _cholesky_factor_of_JtJ(Jcross)
    if L is None:
        raise Exception("Jcross^T Jcross is not positive definite")
    y = torch.linalg.solve_triangular(L, JcT_J, upper=False)
    return -torch.linalg.solve_triangular(L.T, y, upper=True)


def drt_cross_reprojection__dbpacked(icam_intrinsics=0, *, device=None,
                                     **kw):
    """Kpacked (6, Nstate), a numpy array: the linear map from a packed
    state perturbation to the implied rigid transform of the query
    camera's frame,

      Kpacked = -inv(Jcross^T Jcross) Jcross^T J_packed[perturbed cols]

    icam_intrinsics >= 0 gives drt_cam*_cam*/dbpacked of that camera
    ('ccp', fitted to that camera's rows only), icam_intrinsics < 0
    drt_ref_ref*/dbpacked ('rrp', every row).  Runs on the card unless
    device says otherwise."""
    device = resolve_device(device)
    kw = normalize_inputs(kw)
    spec = spec_from_inputs(**kw)
    arrays = arrays_from_inputs(kw, device=device)
    b = pack_params(params_from_arrays(arrays), spec)
    return _drt_cross(spec, arrays, b, icam_intrinsics).cpu().numpy()
