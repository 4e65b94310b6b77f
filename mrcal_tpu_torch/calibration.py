"""Calibration seeding: chessboard corners, monocular and joint poses, the
stereographic seed and the valid-intrinsics region.

Counterpart of ``mrcal_tpu/calibration.py``.  The corners come from a
corners.vnl file or from the port's detector; the per-observation PnP
(the homography's DLT, its pose, and 20 Gauss-Newton steps) runs for all
observations at once on the entry point's device, its 6x6 normal
equations solved by the batched-Cholesky kernel (``ops``) on the card and
by its plain version on the CPU; the pose averaging and the per-frame
Procrustes fits are batched the same way.  The sensor-link traversal and
the regional statistics are host code.  The results are numpy, as the
JAX package's, ready to go into ``optimize()``'s inputs.
"""

import fnmatch
import heapq
import io
import re

import numpy as np
import torch

from ._config import resolve_device
from .ops import cholesky_factor_solve
from .poseutils import (_compose_Rt2, _invert_Rt, _quat_from_R,
                        _R_from_quat, _r_from_R, _Rt_from_rt, _rt_from_Rt,
                        _transform_point_Rt, _transform_point_rt)
from .projections import unproject
from .synthetic_data import ref_calibration_object
from .utils import _align_procrustes_points_Rt01


# ----------------------------------------------------------------------------
# corners.vnl parsing (reference: calibration.py:24 compute_chessboard_corners)
# ----------------------------------------------------------------------------

def compute_chessboard_corners(W, H, *,
                               globs_per_camera=("*",),
                               corners_cache_vnl=None,
                               jobs=1,
                               exclude_images=set(),
                               weight_column_kind="level",
                               device=None):
    """Parse a corners.vnl file (vnlog: '# filename x y level' header + rows;
    a path or a file-like object) into mrcal observation arrays.

    Returns (observations (Nobs,H,W,3), indices_frame_camera (Nobs,2),
    paths).  When no corners cache is supplied, the port's detector runs
    on the glob-matched image files (read with PIL), on `device` (the card
    unless given "cpu")."""
    if corners_cache_vnl is None:
        import glob as _glob
        from .detector import detect_corners_in_images
        image_paths = sorted(set(
            p for g in globs_per_camera for p in _glob.glob(g)))
        if not image_paths:
            raise FileNotFoundError(
                f"no images matched globs {globs_per_camera} and no "
                "corners_cache_vnl was given")
        detections = detect_corners_in_images(image_paths, W, H,
                                              device=device)
        corners_cache_vnl = io.StringIO(corners_vnl(
            (fname, detections[fname]) for fname in image_paths))

    if weight_column_kind not in ("level", "weight", None):
        raise ValueError("weight_column_kind must be level/weight/None")

    # parse the vnlog
    rows = {}
    f = open(corners_cache_vnl) if isinstance(corners_cache_vnl, str) \
        else corners_cache_vnl
    for line in f:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        fields = line.split()
        fname = fields[0]
        if fname == "-" or len(fields) < 3 or fields[1] == "-":
            rows.setdefault(fname, [])
            continue
        x, y = float(fields[1]), float(fields[2])
        w = 1.0
        if len(fields) > 3 and weight_column_kind is not None:
            lvl = float(fields[3]) if fields[3] != "-" else -1.0
            if weight_column_kind == "level":
                # decimation level -> weight = 1/2^level; <0 -> outlier
                w = -1.0 if lvl < 0 else 0.5 ** lvl
            else:
                w = lvl
        rows.setdefault(fname, []).append((x, y, w))
    if f is not corners_cache_vnl:
        f.close()

    filenames = [fn for fn in rows if fn not in exclude_images]
    # assign cameras by glob
    observations = []
    indices_frame_camera = []
    paths = []
    frames = {}
    for fname in filenames:
        icam = None
        for i, g in enumerate(globs_per_camera):
            if fnmatch.fnmatch(fname, g):
                icam = i
                break
        if icam is None:
            continue
        corners = rows[fname]
        if len(corners) != W * H:
            continue
        # frame pairing across cameras: the FIRST digit group in the
        # filename is the frame number (reference pairs by filename frame
        # numbers too: utils.py:788 mapping_file_framenocameraindex)
        mnum = re.search(r"[0-9]+", fname)
        key = mnum.group(0) if mnum else fname
        frames.setdefault(key, len(frames))
        obs = np.array(corners).reshape(H, W, 3)
        observations.append(obs)
        indices_frame_camera.append((frames[key], icam))
        paths.append(fname)

    observations = np.array(observations)
    indices_frame_camera = np.array(indices_frame_camera, dtype=np.int32)
    # renumber frames densely in observation order
    _, inv = np.unique(indices_frame_camera[:, 0], return_inverse=True)
    indices_frame_camera[:, 0] = inv
    order = np.lexsort((indices_frame_camera[:, 1],
                        indices_frame_camera[:, 0]))
    return (observations[order], indices_frame_camera[order],
            [paths[i] for i in order])


def corners_vnl(detections):
    """The corners.vnl text of (filename, detection) pairs, a detection
    being detect_corners_in_images()'s (N,3) [x, y, level] or None (a
    '- - -' row), in the format compute_chessboard_corners reads."""
    lines = ["# filename x y level\n"]
    for fname, det in detections:
        if det is None:
            lines.append(f"{fname} - - -\n")
            continue
        for x, y, lvl in det:
            lines.append(f"{fname} {x:.5f} {y:.5f} {int(lvl)}\n")
    return "".join(lines)


# ----------------------------------------------------------------------------
# PnP: homography seed + Gauss-Newton refinement (replaces cv2.solvePnP),
# all observations at once
# ----------------------------------------------------------------------------

def _homography_dlt(p_board_xy, q_norm, good):
    """DLT homographies board-plane -> normalized image coords, (B, 3, 3):
    p_board_xy (N, 2), q_norm (B, N, 2), good (B, N) the points that take
    part.  Each null vector comes from its system's SVD; its sign is
    arbitrary."""
    B, N = q_norm.shape[:2]
    X = p_board_xy[:, 0].expand(B, N)
    Y = p_board_xy[:, 1].expand(B, N)
    u, v = q_norm[..., 0], q_norm[..., 1]
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    g = good.to(q_norm.dtype)
    r0 = torch.stack([-X, -Y, -one, zero, zero, zero, u * X, u * Y, u], -1)
    r1 = torch.stack([zero, zero, zero, -X, -Y, -one, v * X, v * Y, v], -1)
    A = (torch.stack([r0, r1], dim=-2) * g[..., None, None]).reshape(
        B, 2 * N, 9)
    Vh = torch.linalg.svd(A, full_matrices=False)[2]
    return Vh[:, -1].reshape(B, 3, 3)


def _pose_from_homography(Hm):
    """Decompose plane homographies (B, 3, 3) into (R (B, 3, 3), t (B,
    3)), board -> camera: the scale's sign puts Hm[2,2] > 0, and R is
    projected onto SO(3)."""
    h0, h1, h2 = Hm[..., :, 0], Hm[..., :, 1], Hm[..., :, 2]
    s = 1.0 / torch.sqrt(torch.linalg.vector_norm(h0, dim=-1)
                         * torch.linalg.vector_norm(h1, dim=-1))
    s = torch.where(Hm[..., 2, 2] * s < 0, -s, s)[..., None]
    r0 = h0 * s
    r1 = h1 * s
    t = h2 * s
    r2 = torch.linalg.cross(r0, r1, dim=-1)
    R = torch.stack([r0, r1, r2], dim=-1)
    U, _, Vt = torch.linalg.svd(R)
    R = U @ Vt
    flip = torch.tensor([1.0, 1.0, -1.0], dtype=R.dtype, device=R.device)
    R = torch.where((torch.linalg.det(R) < 0)[:, None, None],
                    (U * flip) @ Vt, R)
    return R, t


def _refine_pnp_gn(rt0, p_board, q_norm, weights, iterations=20):
    """Gauss-Newton refinement of the rt (board->cam) poses rt0 (B, 6)
    minimizing each one's weighted normalized-pinhole reprojection error:
    the residuals and their 6-column Jacobians of all B at once, and the
    (B, 6, 6) normal equations solved by cholesky_factor_solve."""
    eye = torch.eye(6, dtype=rt0.dtype, device=rt0.device)

    def resid(rt, q, w):
        p_cam = _transform_point_rt(rt, p_board)
        qn = p_cam[..., :2] / p_cam[..., 2:3]
        return ((qn - q) * w[..., None]).reshape(-1)

    jac = torch.func.vmap(torch.func.jacfwd(resid))
    res = torch.func.vmap(resid)
    rt = rt0
    for _ in range(iterations):
        r = res(rt, q_norm, weights)
        J = jac(rt, q_norm, weights)                     # (B, 2N, 6)
        JtJ = J.transpose(1, 2) @ J + 1e-9 * eye
        Jtr = (J.transpose(1, 2) @ r[..., None]).contiguous()
        rt = rt - cholesky_factor_solve(JtJ.contiguous(), Jtr)[1][..., 0]
    return rt


def _solve_pnp(q_norm, p_board, w):
    """PnP of each observation from its normalized coords q_norm (B, N,
    2): homography, pose (flipped in front of the camera), Gauss-Newton.
    Returns (rt (B, 6), the rms of each one's normalized reprojection
    error over its good points)."""
    good = w > 0
    Hm = _homography_dlt(p_board[:, :2], q_norm, good)
    R, t = _pose_from_homography(Hm)
    # board behind camera: flip (reference retry logic,
    # calibration.py:560-580)
    behind = t[:, 2] < 0
    flip = torch.tensor([-1.0, -1.0, 1.0], dtype=R.dtype, device=R.device)
    R = torch.where(behind[:, None, None], R * flip, R)
    t = torch.where(behind[:, None], -t, t)
    rt0 = torch.cat([_r_from_R(R), t], dim=-1)
    rt = _refine_pnp_gn(rt0, p_board, q_norm, w)
    p_cam = _transform_point_rt(rt[:, None], p_board)
    qn = p_cam[..., :2] / p_cam[..., 2:3]
    sq = ((qn - q_norm) ** 2 * good[..., None]).sum(dim=(1, 2))
    rms = torch.sqrt(sq / (2 * good.sum(dim=1)))
    return rt, rms


def estimate_monocular_calobject_poses_Rt_tocam(indices_frame_camera,
                                                observations,
                                                object_spacing,
                                                models_or_intrinsics, *,
                                                device=None):
    """Per-observation board pose in camera coords (reference:
    calibration.py:622).  Returns (Nobs, 4, 3) Rt_cam_board, numpy.

    Every observation's PnP runs in one batched pass on `device` (the
    card unless given "cpu"); those whose rms exceeds 0.02 (a focal
    length far off) are solved again in one more batched pass with the
    focal lengths scaled by 1.5 and by 0.7, and the better solve wins, in
    that order (reference focal-retry fallback: calibration.py:508-620)."""
    device = resolve_device(device)
    observations = np.asarray(observations)
    Nobs, H, W = observations.shape[:3]
    icams = np.asarray(indices_frame_camera)[:, 1].astype(np.int64)

    intrinsics = []
    for m in models_or_intrinsics:
        if hasattr(m, "intrinsics"):
            intrinsics.append(m.intrinsics())
        else:
            intrinsics.append(m)

    p_board = torch.as_tensor(
        ref_calibration_object(W, H, object_spacing).reshape(-1, 3),
        device=device)
    obs = torch.as_tensor(observations.reshape(Nobs, -1, 3),
                          dtype=torch.float64, device=device)
    q = obs[..., :2]
    w = torch.clamp_min(obs[..., 2], 0.0)
    if bool(((w > 0).sum(dim=1) < 6).any()):
        raise Exception("too few valid corners")

    def normalized(sel, focal_scale):
        """The normalized coords of observations sel, each unprojected
        by its camera's intrinsics with the focals scaled."""
        out = torch.empty((len(sel),) + q.shape[1:], dtype=q.dtype,
                          device=device)
        for icam in np.unique(icams[sel]):
            lensmodel, intr = intrinsics[icam]
            intr_s = np.array(intr, dtype=float)
            intr_s[:2] *= focal_scale
            k = np.flatnonzero(icams[sel] == icam)
            v = unproject(q[torch.as_tensor(sel[k], device=device)],
                          lensmodel, intr_s, device=device)
            out[torch.as_tensor(k, device=device)] = v[..., :2] / v[..., 2:3]
        return out

    every = np.arange(Nobs)
    rt, rms = _solve_pnp(normalized(every, 1.0), p_board, w)
    retry = np.flatnonzero(rms.cpu().numpy() > 0.02)
    if len(retry):
        scales = (1.5, 0.7)
        both = np.concatenate([retry] * len(scales))
        q_norm = torch.cat([normalized(retry, s) for s in scales])
        rt2, rms2 = _solve_pnp(q_norm, p_board,
                               w[torch.as_tensor(both, device=device)])
        sel = torch.as_tensor(retry, device=device)
        best_rt, best_rms = rt[sel], rms[sel]
        for k in range(len(scales)):
            part = slice(k * len(retry), (k + 1) * len(retry))
            better = rms2[part] < best_rms
            best_rt = torch.where(better[:, None], rt2[part], best_rt)
            best_rms = torch.where(better, rms2[part], best_rms)
        rt = rt.index_copy(0, sel, best_rt)
    return _Rt_from_rt(rt).cpu().numpy()


# ----------------------------------------------------------------------------
# multi-camera joint seeding (reference: calibration.py:925-1397)
# ----------------------------------------------------------------------------

def traverse_sensor_links(*, connectivity_matrix, callback_sensor_link):
    """Find optimal paths from sensor 0 to every other sensor in a
    connectivity graph (reference: mrcal.h:935-960 /
    traverse-sensor-links.c:39-48; Python binding mrcal-pywrap.c
    traverse_sensor_links).

    connectivity_matrix: (Nsensors, Nsensors) symmetric array with a 0
    diagonal; element (i,j) is the number of shared observations between
    sensors i and j (0 = no connection).

    callback_sensor_link(idx_to, idx_from) is invoked for each optimal
    link, in the order the sensors are reached (Dijkstra finalization
    order, minimizing hop count with total-shared-observations as the
    tie-break: edge cost 65536 - Nshared).  Returning False from the
    callback aborts the traversal and makes this function return False.

    Disjoint sensors never get a callback — the caller must notice.
    Returns True on success."""
    c = np.asarray(connectivity_matrix)
    if c.ndim != 2 or c.shape[0] != c.shape[1]:
        raise Exception("connectivity_matrix must be square (Nsensors x "
                        f"Nsensors); got {c.shape}")
    if np.any(c != c.T) or np.any(np.diag(c) != 0):
        raise Exception("connectivity_matrix must be symmetric with a 0 "
                        "diagonal")
    N = c.shape[0]
    INF = float("inf")
    dist = [INF] * N
    parent = [-1] * N
    dist[0] = 0
    pq = [(0, 0)]
    done = [False] * N
    while pq:
        d, u = heapq.heappop(pq)
        if done[u]:
            continue
        done[u] = True
        if parent[u] >= 0:
            if callback_sensor_link(u, parent[u]) is False:
                return False
        for v in range(N):
            if v == u or c[u, v] == 0:
                continue
            cost = 65536 - int(c[u, v])
            if d + cost < dist[v]:
                dist[v] = d + cost
                parent[v] = u
                heapq.heappush(pq, (d + cost, v))
    return True


def _traverse_sensor_links(Ncameras, shared_frames):
    """Dijkstra over the camera-connectivity graph: cost of an edge is
    65536 - Nshared (reference: traverse-sensor-links.c:39-48).
    Returns parent[] of the tree rooted at camera 0."""
    INF = float("inf")
    dist = [INF] * Ncameras
    parent = [-1] * Ncameras
    dist[0] = 0
    pq = [(0, 0)]
    done = [False] * Ncameras
    while pq:
        d, u = heapq.heappop(pq)
        if done[u]:
            continue
        done[u] = True
        for v in range(Ncameras):
            if v == u or shared_frames[u][v] == 0:
                continue
            cost = 65536 - shared_frames[u][v]
            if d + cost < dist[v]:
                dist[v] = d + cost
                parent[v] = u
                heapq.heappush(pq, (d + cost, v))
    return parent


def _estimate_camera_poses(calobject_poses_local_Rt_cf,
                           indices_frame_camera, Ncameras, *, device=None):
    """Pairwise camera poses averaged over shared frames, chained into
    camera-0-referenced poses via the sensor-link graph
    (reference: calibration.py:925).  Returns Rt_cam_camera0 (Ncameras,
    4, 3), numpy."""
    device = resolve_device(device)
    Rt_cf = torch.as_tensor(np.asarray(calobject_poses_local_Rt_cf,
                                       dtype=np.float64), device=device)
    Nobs = len(indices_frame_camera)
    # group observations by frame
    byframe = {}
    for i in range(Nobs):
        f, c = int(indices_frame_camera[i, 0]), int(indices_frame_camera[i, 1])
        byframe.setdefault(f, {})[c] = i

    shared = [[0] * Ncameras for _ in range(Ncameras)]
    for f, cams in byframe.items():
        for c0 in cams:
            for c1 in cams:
                if c0 != c1:
                    shared[c0][c1] += 1

    parent = _traverse_sensor_links(Ncameras, shared)

    def pairwise_Rt01(c0, c1):
        """Average Rt_c0_c1 over shared frames: mean translation; the
        rotation's mean through the quaternions' mean."""
        pairs = [(cams[c0], cams[c1]) for cams in byframe.values()
                 if c0 in cams and c1 in cams]
        i0, i1 = (torch.as_tensor(i, device=device) for i in zip(*pairs))
        Rts = _compose_Rt2(Rt_cf[i0], _invert_Rt(Rt_cf[i1]))
        t = Rts[:, 3, :].mean(dim=0)
        q = _quat_from_R(Rts[:, :3, :]).mean(dim=0)
        q = q / torch.linalg.vector_norm(q)
        return torch.cat([_R_from_quat(q), t[None]], dim=0)

    Rt_0c = [None] * Ncameras           # camera c -> camera 0
    Rt_0c[0] = torch.cat([torch.eye(3, dtype=torch.float64, device=device),
                          torch.zeros((1, 3), dtype=torch.float64,
                                      device=device)])
    # fill in BFS order over the tree
    pending = [c for c in range(1, Ncameras)]
    while pending:
        progressed = False
        for c in list(pending):
            p = parent[c]
            if p < 0:
                raise Exception(f"camera {c} not connected to camera 0")
            if Rt_0c[p] is not None:
                Rt_0c[c] = _compose_Rt2(Rt_0c[p], pairwise_Rt01(p, c))
                pending.remove(c)
                progressed = True
        if not progressed:
            raise Exception("camera connectivity graph is disconnected")
    # Rt_cam_camera0: cameras relative to camera 0 == reference
    return _invert_Rt(torch.stack(Rt_0c)).cpu().numpy()


def estimate_joint_frame_poses(calobject_Rt_camera_frame,
                               extrinsics_Rt_fromref,
                               indices_frame_camera,
                               object_width_n, object_height_n,
                               object_spacing, *, device=None):
    """Combine per-camera board-pose estimates into one pose per frame
    (reference: calibration.py:1186): each frame's board, as every camera
    that saw it places it in the reference, averaged, and the board fitted
    to the average (a Procrustes fit, all frames at once).

    extrinsics_Rt_fromref: (Ncameras-1, 4, 3) — camera 0 is the reference
    (identity), like the reference API (Rt_cam_ref[icam-1]).  Returns
    rt_ref_frame (Nframes, 6), numpy; runs on `device` (the card unless
    given "cpu")."""
    device = resolve_device(device)
    idx = np.asarray(indices_frame_camera)
    Nframes = int(np.max(idx[:, 0])) + 1
    p_board = torch.as_tensor(ref_calibration_object(
        object_width_n, object_height_n, object_spacing).reshape(-1, 3),
        device=device)
    Rt_cf = torch.as_tensor(np.asarray(calobject_Rt_camera_frame,
                                       dtype=np.float64), device=device)
    ext = torch.as_tensor(np.asarray(extrinsics_Rt_fromref,
                                     dtype=np.float64).reshape(-1, 4, 3),
                          device=device)
    Rt_ref_cam = torch.cat([torch.cat([
        torch.eye(3, dtype=torch.float64, device=device),
        torch.zeros((1, 3), dtype=torch.float64, device=device)])[None],
        _invert_Rt(ext)])
    frame = torch.as_tensor(idx[:, 0].astype(np.int64), device=device)
    icam = torch.as_tensor(idx[:, 1].astype(np.int64), device=device)
    Rt_ref_frame_i = _compose_Rt2(Rt_ref_cam[icam], Rt_cf)
    ps_ref = _transform_point_Rt(Rt_ref_frame_i[:, None], p_board)
    ps_sum = torch.zeros((Nframes,) + ps_ref.shape[1:], dtype=ps_ref.dtype,
                         device=device).index_add_(0, frame, ps_ref)
    count = torch.bincount(frame, minlength=Nframes).to(ps_ref.dtype)
    ps_mean = ps_sum / count[:, None, None]
    Rt = _align_procrustes_points_Rt01(
        ps_mean, p_board.expand_as(ps_mean),
        torch.ones(ps_mean.shape[:-1], dtype=ps_mean.dtype, device=device))
    # rt (Nframes, 6), like the reference (calibration.py:1395 returns
    # rt_ref_frame)
    return _rt_from_Rt(Rt).cpu().numpy()


def seed_stereographic(imagersizes, focal_estimate,
                       indices_frame_camera, observations,
                       object_spacing, *, device=None):
    """Full calibration seed assuming LENSMODEL_STEREOGRAPHIC intrinsics
    (reference: calibration.py:1398).  Returns numpy
    (intrinsics_data, extrinsics_rt_fromref, frames_rt_toref); runs on
    `device` (the card unless given "cpu")."""
    device = resolve_device(device)
    imagersizes = np.asarray(imagersizes)
    Ncameras = imagersizes.shape[0]
    H, W = observations.shape[1:3]
    focals = np.broadcast_to(np.asarray(focal_estimate, dtype=float),
                             (Ncameras,))
    intrinsics = np.array(
        [[f, f, (imagersizes[i][0] - 1) / 2., (imagersizes[i][1] - 1) / 2.]
         for i, f in enumerate(focals)])

    models = [("LENSMODEL_STEREOGRAPHIC", intrinsics[i])
              for i in range(Ncameras)]
    Rt_cf = estimate_monocular_calobject_poses_Rt_tocam(
        indices_frame_camera, observations, object_spacing, models,
        device=device)

    if Ncameras > 1:
        Rt_cam_ref = _estimate_camera_poses(Rt_cf, indices_frame_camera,
                                            Ncameras, device=device)
    else:
        Rt_cam_ref = np.concatenate([np.eye(3), np.zeros((1, 3))])[None]

    frames_rt_toref = estimate_joint_frame_poses(
        Rt_cf, Rt_cam_ref[1:], indices_frame_camera, W, H, object_spacing,
        device=device)

    # camera 0 is the reference: Ncameras-1 extrinsics entries
    extrinsics_rt_fromref = _rt_from_Rt(torch.as_tensor(
        Rt_cam_ref[1:], device=device)).cpu().numpy().reshape(-1, 6)
    return intrinsics, extrinsics_rt_fromref, frames_rt_toref


# ----------------------------------------------------------------------------
# valid-intrinsics region (reference: calibration.py:1611, :1720)
# ----------------------------------------------------------------------------

def _report_regional_statistics(model, *, gridn_width=30, gridn_height=None,
                                device=None):
    """Per-region residual statistics over the imager (reference:
    calibration.py:1720).  Returns (mean, stdev, count) arrays of shape
    (gridn_height, gridn_width); the residuals are evaluated on `device`
    (the card unless given "cpu")."""
    oi = model.optimization_inputs()
    if oi is None:
        raise Exception("model has no optimization_inputs")
    from .utils import measurements_board
    icam = model.icam_intrinsics() or 0
    W, H = model.imagersize()
    if gridn_height is None:
        gridn_height = int(round(H / W * gridn_width))

    res = measurements_board(oi, device=device)
    obs = np.asarray(oi["observations_board"])
    idx = np.asarray(oi["indices_frame_camintrinsics_camextrinsics"])
    sel = idx[:, 1] == icam
    res = res[sel]
    obs = obs[sel]
    inlier = obs[..., 2] > 0
    q = obs[..., :2][inlier]
    r = res[inlier]
    mag = np.linalg.norm(r, axis=-1)

    gx = np.clip((q[:, 0] / W * gridn_width).astype(int), 0, gridn_width - 1)
    gy = np.clip((q[:, 1] / H * gridn_height).astype(int), 0,
                 gridn_height - 1)
    count = np.zeros((gridn_height, gridn_width))
    s1 = np.zeros((gridn_height, gridn_width, 2))
    s2 = np.zeros((gridn_height, gridn_width))
    np.add.at(count, (gy, gx), 1)
    np.add.at(s1, (gy, gx), r)
    np.add.at(s2, (gy, gx), mag * mag)
    cnt_safe = np.maximum(count, 1)
    mean = np.linalg.norm(s1 / cnt_safe[..., None], axis=-1)
    stdev = np.sqrt(np.maximum(s2 / cnt_safe - 0, 0))
    return mean, stdev, count


def _compute_valid_intrinsics_region(model,
                                     threshold_uncertainty=1.0,
                                     threshold_mean=0.5,
                                     threshold_stdev=1.0,
                                     threshold_count=3,
                                     distance=0.0,
                                     gridn_width=30, gridn_height=None, *,
                                     device=None):
    """The valid-intrinsics region: the contour of the area where the
    regional residual statistics and the projection uncertainty
    (mean-pcam, worstdirection-stdev) are all within thresholds
    (reference: calibration.py:1611).  Returns a closed (N,2) pixel
    contour (marching squares by contourpy when it is importable, else
    the mask's bounding box), numpy.  The uncertainty is computed on
    `device` (the card unless given "cpu")."""
    from .model_analysis import projection_uncertainty
    from .utils import close_contour, sample_imager

    W, H = model.imagersize()
    if gridn_height is None:
        gridn_height = int(round(H / W * gridn_width))
    mean, stdev, count = _report_regional_statistics(
        model, gridn_width=gridn_width, gridn_height=gridn_height,
        device=device)
    q = sample_imager(gridn_width, gridn_height, W, H, device=device)
    vcam = unproject(q, *model.intrinsics(), normalize=True,
                     device=q.device)
    atinfinity = distance <= 0
    pcam = vcam if atinfinity else vcam * distance
    unc = projection_uncertainty(
        pcam.reshape(-1, 3), model, method="mean-pcam",
        atinfinity=atinfinity, what="worstdirection-stdev",
        device=q.device).cpu().numpy().reshape(mean.shape)
    q = q.cpu().numpy()
    unc[~np.isfinite(unc)] = 1e9
    mask = unc < threshold_uncertainty
    if not re.match("LENSMODEL_SPLINED_", model.intrinsics()[0]):
        mask &= (mean < threshold_mean) & (stdev < threshold_stdev) & \
                (count > threshold_count)
    if not np.any(mask):
        return np.zeros((0, 2))

    # extract the boundary contour of the mask (marching squares)
    try:
        import contourpy
        gen = contourpy.contour_generator(
            x=q[..., 0], y=q[..., 1], z=mask.astype(float))
        lines = gen.lines(0.5)
        if not lines:
            return np.zeros((0, 2))
        contour = max(lines, key=len)
    except ImportError:
        # fall back: bounding box of the mask
        ys, xs = np.nonzero(mask)
        x0, x1 = q[0, xs.min(), 0], q[0, xs.max(), 0]
        y0, y1 = q[ys.min(), 0, 1], q[ys.max(), 0, 1]
        contour = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])
    return close_contour(np.asarray(contour))
