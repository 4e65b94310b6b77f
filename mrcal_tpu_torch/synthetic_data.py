"""Synthetic calibration scenes, in PyTorch.

Counterpart of ``mrcal_tpu/synthetic_data.py``: the calibration object's
geometry, random chessboard dances seen by a set of cameras, perfect (or
noisy) reprojections of a solve's state, and feature tracks of a camera
moving over a ground plane.

The random draws are numpy's, from its GLOBAL generator, in the JAX
package's order (``np.random.uniform`` per chunk of board poses,
``np.random.randn`` for the pixel noise), so the same ``np.random.seed``
gives the same frames, the same culled set and the same noise in both
packages.  The draws and the culling stay on the host; the projections
run on the device, the card unless a function is given ``device="cpu"``.
Every function returns numpy arrays.
"""

import numpy as np
import torch

from ._config import resolve_device
from .lensmodels import project_core, unproject_core
from .optimize.layout import spec_from_inputs
from .optimize.residuals import (arrays_from_inputs, board_points_ref,
                                 params_from_arrays)
from .poseutils import (_compose_Rt2, _compose_rt2, _invert_Rt,
                        _Rt_from_rt, _transform_point_Rt, _transform_point_rt)

_CPU = torch.device("cpu")


def _tensor(a, device):
    return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)


def ref_calibration_object(W=None, H=None, object_spacing=None, *,
                           optimization_inputs=None,
                           calobject_warp=None,
                           x_corner0=0, x_corner1=None, Nx=None,
                           y_corner0=0, y_corner1=None, Ny=None):
    """The calibration object's corners in board coordinates, (..., Ny,
    Nx, 3): corner (0, 0) at the origin, x along the rows, and z the
    2-parameter parabolic warp z = kx 4 xr (1 - xr) + ky 4 yr (1 - yr) with
    xr = x / (W - 1).  Leading dims of calobject_warp broadcast.  The
    corner sub-range [x_corner0, x_corner1] in Nx steps (and y alike)
    defaults to the whole board; optimization_inputs supplies W, H, the
    spacing and the warp."""
    if optimization_inputs is not None:
        W = optimization_inputs["observations_board"].shape[-2]
        H = optimization_inputs["observations_board"].shape[-3]
        object_spacing = optimization_inputs["calibration_object_spacing"]
        calobject_warp = optimization_inputs.get("calobject_warp")

    if x_corner1 is None:
        x_corner1 = W - 1
    if Nx is None:
        Nx = W
    if y_corner1 is None:
        y_corner1 = H - 1
    if Ny is None:
        Ny = H

    xg, yg = np.meshgrid(np.linspace(x_corner0, x_corner1, Nx),
                         np.linspace(y_corner0, y_corner1, Ny))
    full = np.zeros((Ny, Nx, 3))
    full[..., 0] = xg * object_spacing
    full[..., 1] = yg * object_spacing
    if calobject_warp is None:
        return full

    cw = np.asarray(calobject_warp)
    xr = xg / (W - 1)
    yr = yg / (H - 1)
    if cw.ndim == 1:
        full[..., 2] = (cw[0] * 4 * xr * (1 - xr) +
                        cw[1] * 4 * yr * (1 - yr))
        return full
    out = np.zeros(cw.shape[:-1] + (Ny, Nx, 3))
    out[...] = full
    out[..., 2] = (cw[..., 0:1, None] * 4 * xr * (1 - xr) +
                   cw[..., 1:2, None] * 4 * yr * (1 - yr))
    return out


WHICH = ('all-cameras-must-see-full-board',
         'some-cameras-must-see-full-board',
         'all-cameras-must-see-half-board',
         'some-cameras-must-see-half-board')


def synthesize_board_observations(models, *,
                                  object_width_n, object_height_n,
                                  object_spacing, calobject_warp,
                                  rt_ref_boardcenter,
                                  rt_ref_boardcenter__noiseradius,
                                  Nframes,
                                  max_oblique_angle_deg=None,
                                  pcamera_nominal_ref=np.zeros(3),
                                  which='all-cameras-must-see-full-board',
                                  device=None):
    """Random chessboard observations by the cameras `models`.

    Board poses are drawn uniformly within rt_ref_boardcenter +-
    rt_ref_boardcenter__noiseradius, Nframes at a time, and culled: by
    the angle between the board's normal and the ray from
    pcamera_nominal_ref (max_oblique_angle_deg), then by `which` of the
    cameras must see the whole board, or more than half of it, in the
    imager.  Chunks are drawn until Nframes poses are kept.

    Returns (q (Nframes, Ncameras, H, W, 2), Rt_ref_boardref (Nframes, 4,
    3)), numpy: Rt_ref_boardref maps the ref_calibration_object() frame
    (corner 0 at the origin) to the reference.  The poses are composed on
    the CPU; the boards are transformed into each camera and projected on
    `device` (the card unless given "cpu")."""
    if which not in WHICH:
        raise Exception(f"'which' must be one of {WHICH}")
    device = resolve_device(device)

    Ncameras = len(models)
    board_center = np.array(((object_width_n - 1) * object_spacing / 2.,
                             (object_height_n - 1) * object_spacing / 2.,
                             0))
    board_reference = _tensor(ref_calibration_object(
        object_width_n, object_height_n, object_spacing,
        calobject_warp=calobject_warp) - board_center, device)
    Rt_boardref_origboardref = np.concatenate([np.eye(3),
                                               -board_center[None]])

    max_cos = (np.cos(max_oblique_angle_deg * np.pi / 180)
               if max_oblique_angle_deg is not None else None)

    cameras = [(_tensor(m.Rt_cam_ref(), device), m.intrinsics()[0],
                _tensor(m.intrinsics()[1], device)) for m in models]
    imagersizes = [np.asarray(m.imagersize()) for m in models]

    def chunk():
        randomblock = np.random.uniform(-1.0, 1.0, size=(Nframes, 6))
        rt = np.asarray(rt_ref_boardcenter) + \
            randomblock * np.asarray(rt_ref_boardcenter__noiseradius)
        Rt_ref_boardref = _Rt_from_rt(_tensor(rt, _CPU))
        boards_ref = _transform_point_Rt(
            Rt_ref_boardref.to(device)[:, None, None], board_reference)
        q = torch.stack([
            project_core(_transform_point_Rt(Rt, boards_ref), intr, lens)
            for Rt, lens, intr in cameras], dim=1)  # (Nframes, Ncam, H, W, 2)
        return q.cpu().numpy(), Rt_ref_boardref.numpy()

    def cull(q, Rt_ref_boardref):
        if max_cos is not None:
            npos = Rt_ref_boardref[..., 3, :] - pcamera_nominal_ref
            npos = npos / np.linalg.norm(npos, axis=-1, keepdims=True)
            nori = Rt_ref_boardref[..., :3, 2]
            costh = np.abs(np.sum(npos * nori, axis=-1))
            keep = costh > max_cos
            q = q[keep]
            Rt_ref_boardref = Rt_ref_boardref[keep]
        mask = (q[..., 0] >= 0) & (q[..., 1] >= 0)
        for i in range(Ncameras):
            Wpx, Hpx = imagersizes[i]
            mask[:, i] &= (q[:, i, ..., 0] <= Wpx - 1) & \
                          (q[:, i, ..., 1] <= Hpx - 1)
        Nvis = np.count_nonzero(mask, axis=(-1, -2))
        Npt = object_width_n * object_height_n
        seen = Nvis == Npt if 'full' in which else Nvis > Npt // 2
        keep = (np.all if which.startswith('all') else np.any)(seen, axis=-1)
        return q[keep], Rt_ref_boardref[keep]

    q_all = np.zeros((0, Ncameras, object_height_n, object_width_n, 2))
    Rt_all = np.zeros((0, 4, 3))
    while True:
        q, Rt = cull(*chunk())
        q_all = np.concatenate([q_all, q], axis=0)
        Rt_all = np.concatenate([Rt_all, Rt], axis=0)
        if q_all.shape[0] >= Nframes:
            break

    return q_all[:Nframes], _compose_Rt2(
        _tensor(Rt_all[:Nframes], _CPU),
        _tensor(Rt_boardref_origboardref, _CPU)).numpy()


def make_perfect_observations(optimization_inputs, *,
                              observed_pixel_uncertainty=None, device=None):
    """Overwrite the board and point observations in optimization_inputs
    (in place) with perfect reprojections of its state, plus gaussian
    pixel noise of that many pixels, from the global numpy RNG, if
    observed_pixel_uncertainty is given.  The projections run on `device`
    (the card unless given "cpu")."""
    device = resolve_device(device)
    spec = spec_from_inputs(**optimization_inputs)
    arrays = arrays_from_inputs(optimization_inputs, device=device)
    params = params_from_arrays(arrays)
    ext = torch.cat([params["extrinsics"].new_zeros((1, 6)),
                     params["extrinsics"]], dim=0)

    def observe(key, p_cam, ici):
        obs = np.asarray(optimization_inputs[key])
        q = project_core(p_cam, params["intrinsics"][ici],
                         spec.lensmodel).cpu().numpy()
        obs[..., :2] = q
        if observed_pixel_uncertainty:
            obs[..., :2] += np.random.randn(*q.shape) * \
                observed_pixel_uncertainty

    def indices(key):
        idx = np.asarray(optimization_inputs[key])
        return (torch.as_tensor(idx[:, i], dtype=torch.int64, device=device)
                for i in range(3))

    if spec.Nobservations_board:
        ifr, ici, ice = indices("indices_frame_camintrinsics_camextrinsics")
        rt_joint = _compose_rt2(ext[ice + 1], params["frames"][ifr])
        pts = board_points_ref(spec, params["calobject_warp"])
        p_cam = _transform_point_rt(rt_joint[:, None, None, :], pts[None])
        observe("observations_board", p_cam, ici[:, None, None])

    if spec.Nobservations_point:
        ipt, ici, ice = indices("indices_point_camintrinsics_camextrinsics")
        p_cam = _transform_point_rt(ext[ice + 1], params["points"][ipt])
        observe("observations_point", p_cam, ici)


def make_tracks(model, *,
                Rt_NED_cam0=None,
                R_cam_camnext=None,
                t_cam_camnext__world=None,
                Nobservations_total=1000,
                track_length=4,
                Nobservations_image=50,
                gridn=10,
                Npoint_observations_min=4,
                Ncam_observing_min=4,
                device=None):
    """Feature tracks for SfM: a camera moving over a ground plane (z = 0
    in the world's NED frame) observes persistent ground features.

    The camera starts at Rt_NED_cam0 (100 m up, looking down) and each
    next pose is the last one's composed with R_cam_camnext and shifted by
    t_cam_camnext__world.  The features are a gridn x gridn pixel grid of
    every (track_length // 2)-th camera cast onto the ground, one per 5 m
    cell.  Each feature is observed by the first track_length cameras, in
    order, that see it in front of them and inside the imager; it is kept
    if they are at least max(2, min(Npoint_observations_min,
    Ncam_observing_min)), until Nobservations_total observations are
    kept.  The grid's unprojection and the projections of every
    (feature, camera) pair run on `device` (the card unless given "cpu"),
    each in one call.

    Returns (observations (N, 2), indices (N, 2) of [ipoint, icam],
    points (Npoints, 3) in the world, Rt_NED_cam (Ncameras, 4, 3))."""
    device = resolve_device(device)
    W, H = model.imagersize()
    lens, intr = model.intrinsics()
    intr = _tensor(intr, device)
    if Rt_NED_cam0 is None:
        # 100 m up (NED: z down), looking down: the camera's +z (forward)
        # is NED's +z, so the identity rotation looks at the ground
        Rt_NED_cam0 = np.concatenate([np.eye(3), [[0., 0., -100.]]], axis=0)
    if R_cam_camnext is None:
        R_cam_camnext = np.eye(3)
    if t_cam_camnext__world is None:
        t_cam_camnext__world = np.array([20.0, 0.0, 0.0])

    Ncameras = max(2, int(np.ceil(Nobservations_total /
                                  max(Nobservations_image, 1))))
    Rt_NED_cam = np.zeros((Ncameras, 4, 3))
    Rt_NED_cam[0] = Rt_NED_cam0
    for i in range(1, Ncameras):
        Rt_NED_cam[i, :3] = Rt_NED_cam[i - 1, :3] @ R_cam_camnext
        Rt_NED_cam[i, 3] = Rt_NED_cam[i - 1, 3] + t_cam_camnext__world

    # ground features: one pixel grid, unprojected once, cast from every
    # (track_length // 2)-th camera onto the ground, deduplicated on a
    # 5 m world grid
    qx = np.linspace(0.05 * W, 0.95 * W, gridn)
    qy = np.linspace(0.05 * H, 0.95 * H, gridn)
    qg = np.stack(np.meshgrid(qx, qy), axis=-1).reshape(-1, 2)
    vcam = unproject_core(_tensor(qg, device), intr, lens).cpu().numpy()
    points = []
    for i in range(0, Ncameras, max(1, track_length // 2)):
        vw = vcam @ Rt_NED_cam[i, :3].T
        pc = Rt_NED_cam[i, 3]
        with np.errstate(divide="ignore", invalid="ignore"):
            d = -pc[2] / vw[:, 2]
        ok = np.isfinite(d) & (d > 0)
        points.append(pc + d[ok, None] * vw[ok])
    points = np.concatenate(points, axis=0)
    key = np.round(points[:, :2] / 5.0).astype(int)
    _, uniq = np.unique(key, axis=0, return_index=True)
    points = points[np.sort(uniq)]

    # every (feature, camera) pair at once
    Rt_cam_NED = _invert_Rt(_tensor(Rt_NED_cam, device))
    p_cam = _transform_point_Rt(Rt_cam_NED[None],
                                _tensor(points, device)[:, None])
    q = project_core(p_cam, intr, lens).cpu().numpy()   # (Npoints, Ncam, 2)
    with np.errstate(invalid="ignore"):
        seen = ((p_cam[..., 2] > 0).cpu().numpy()
                & (0 <= q[..., 0]) & (q[..., 0] <= W - 1)
                & (0 <= q[..., 1]) & (q[..., 1] <= H - 1))

    Nmin = max(2, min(Npoint_observations_min, Ncam_observing_min))
    observations = []
    indices = []
    for ip in range(len(points)):
        cams = np.flatnonzero(seen[ip])[:track_length]
        if len(cams) >= Nmin:
            observations += list(q[ip, cams])
            indices += [(ip, ic) for ic in cams]
        if len(observations) >= Nobservations_total:
            break

    return (np.array(observations), np.array(indices, dtype=np.int32),
            points, Rt_NED_cam)
