"""Synthetic calibration problems, built without JAX.

Ports the JAX package's problem builders so that the port's own tools
(``chip_smoke.py``) can make the bench problems: ``make_problem`` is
``__graft_entry__._make_problem`` (``make_perfect_observations`` is
``synthetic_data``'s, imported here for the callers of this module),
``perturbed_oi`` is ``bench._perturbed_oi``, and ``opencv8_1cam``,
``opencv8_4cam``, ``splined_30x18``, ``rig16cam`` and ``sfm_triangulated``
are the bench's configurations of those names; ``cahvor_1cam`` and
``cahvore_1cam`` are opencv8_1cam's with the CAHVOR and CAHVORE
models.  ``stereo_opencv8_2cam`` is a two-camera OPENCV8 rig calibrated
from a chessboard dance made by ``synthetic_data``, as the JAX package's
tests make their scenes.  ``sfm_points`` is an aerial survey with its
ground features in the state (mrcal's test-sfm-fixed-points), from
``synthetic_data.make_tracks``.

The builders draw from the GLOBAL numpy RNG in exactly the JAX package's
order (``np.random.seed(0)``, then ``randn`` for the frames, then ``randn``
for the observation noise; for sfm_triangulated ``uniform`` three times
for the points, then ``randn`` per observation), so the problems are
identical to the JAX package's.  Their arithmetic runs on the CPU in
float64 (``stereo_opencv8_2cam``'s projections on the card unless it is
given ``device="cpu"``): the output is numpy.
"""

import copy

import numpy as np
import torch

from . import convert, synthetic_data
from .cameramodel import cameramodel
from .lensmodels import lensmodel_num_params, project_core
from .poseutils import (_compose_Rt2, _invert_Rt, _invert_rt, _rt_from_Rt,
                        _transform_point_Rt, _transform_point_rt)
from .synthetic_data import make_perfect_observations

_CPU = torch.device("cpu")

# bench.py's opencv8_1cam configuration: one camera, 84 frames of a 14x14
# board (Nmeasurements 32938, Nstate 518)
OPENCV8_1CAM = dict(Ncameras=1, Nframes=84, model="LENSMODEL_OPENCV8",
                    W=14, H=14)

# bench.py's opencv8_4cam configuration: four cameras, 84 frames of a
# 14x14 board (Nmeasurements 131752, Nstate 572)
OPENCV8_4CAM = dict(Ncameras=4, Nframes=84, model="LENSMODEL_OPENCV8",
                    W=14, H=14)

# bench.py's splined_30x18 configuration: the canonical splined model, one
# camera with its core locked, 84 frames of a 14x14 board (Nmeasurements
# 34008 = 32928 board + 1080 regularization, Nstate 1586 = 1080 + 84*6 + 2)
SPLINED_30X18 = dict(Ncameras=1, Nframes=84,
                     model="LENSMODEL_SPLINED_STEREOGRAPHIC_order=3_Nx=30"
                           "_Ny=18_fov_x_deg=150",
                     W=14, H=14, do_optimize_intrinsics_core=False)

# opencv8_1cam's shape with the CAHVOR model, and with CAHVORE at
# linearity 0.37 (the models tests/test_gradients.py optimizes): one
# camera, 84 frames of a 14x14 board (Nmeasurements 32935 and 32938,
# Nstate 515 and 518)
CAHVOR_1CAM = dict(OPENCV8_1CAM, model="LENSMODEL_CAHVOR")
CAHVORE_1CAM = dict(OPENCV8_1CAM, model="LENSMODEL_CAHVORE_linearity=0.37")

# bench.py's rig16cam configuration: a 4x4 rig of OPENCV8 cameras on a
# 0.15 m grid, all facing the board, and 40 tame poses of a 14x14 board
# (Nmeasurements 251040, Nstate 524)
RIG16CAM = dict(Ncameras=16, Nframes=40, model="LENSMODEL_OPENCV8", W=14,
                H=14)

# stereo_opencv8_2cam: a stereo rig of two OPENCV8 cameras of 800x600,
# 0.22 m apart, calibrated from 84 frames of a 14x14 board (0.077 m) that
# both see whole (the JAX package's tests/test_calibration.py scene
# recipe; Nmeasurements 65876 = 2*84*196*2 board + 2*10 regularization,
# Nstate 536 = 2*12 + 6 + 84*6 + 2)
STEREO_OPENCV8_2CAM = dict(Ncameras=2, spacing=0.077, warp=(0.002, -0.001),
                           rig_spacing=0.22)

# sfm_points: a camera flying 100 m over the ground, a frame each 20 m,
# its features tracked over 4 frames each; the features are in the state,
# the last 4 of them fixed (surveyed).  At this size: 398 frames, 15000
# points, Nmeasurements 120000, Nstate 47370 = 397*6 + 14996*3.
# sfm_points_20k (Nobservations_total=20000): 134 frames, 5000 points,
# Nmeasurements 40000, Nstate 15786 = 133*6 + 4996*3
SFM_POINTS = dict(Nobservations_total=60000, Nobservations_image=150,
                  noise_px=0.3, Npoints_fixed=4)
SFM_POINTS_20K = dict(SFM_POINTS, Nobservations_total=20000)


def make_problem(Ncameras=2, Nframes=8, model="LENSMODEL_OPENCV8", W=6, H=5,
                 *, device, dtype=torch.float64, **extra_oi):
    """Small synthetic calibration problem.  extra_oi entries
    (do_optimize_* flags etc) are merged into the optimization_inputs.
    Returns (optimization_inputs, spec, arrays, b0) with arrays and b0 on
    `device`."""
    np.random.seed(0)
    imagersize = np.array([800, 600])
    n = lensmodel_num_params(model)
    intr = np.array([[750. + 10 * i, 748. + 10 * i,
                      (imagersize[0] - 1) / 2, (imagersize[1] - 1) / 2]
                     + [0.0] * (n - 4) for i in range(Ncameras)])
    ext = np.array([[0.01 * i, -0.01 * i, 0.0, -0.2 * i, 0.0, 0.0]
                    for i in range(1, Ncameras)]).reshape(-1, 6)
    frames = np.concatenate([
        np.random.randn(Nframes, 3) * 0.3,
        np.array([[0.05, -0.05, 1.1]]) + np.random.randn(Nframes, 3) * 0.1,
    ], axis=1)

    # perfect observations via the forward model, then a little noise
    oi = dict(
        intrinsics=intr, extrinsics_rt_fromref=ext, frames_rt_toref=frames,
        points=None,
        observations_board=np.zeros((Nframes * Ncameras, H, W, 3)),
        indices_frame_camintrinsics_camextrinsics=np.array(
            [[f, c, c - 1] for f in range(Nframes) for c in range(Ncameras)],
            dtype=np.int32),
        observations_point=None,
        indices_point_camintrinsics_camextrinsics=None,
        lensmodel=model,
        imagersizes=np.tile(imagersize, (Ncameras, 1)),
        calobject_warp=np.array([0.001, -0.001]),
        calibration_object_spacing=0.08,
    )
    oi.update(extra_oi)
    oi["observations_board"][..., 2] = 1.0
    make_perfect_observations(oi, observed_pixel_uncertainty=0.3,
                              device=_CPU)
    spec, arrays, b0 = convert.from_reference(oi, device=device, dtype=dtype)
    return oi, spec, arrays, b0


def perturbed_oi(oi, seed=1, scale=1e-2, perturb_intrinsics=False):
    """Deep-copy optimization_inputs with the GEOMETRY arrays perturbed so
    the solve runs many LM iterations (bench._perturbed_oi)."""
    oi = copy.deepcopy(oi)
    rng = np.random.default_rng(seed)
    scales = {"extrinsics_rt_fromref": scale, "rt_cam_ref": scale,
              "frames_rt_toref": scale, "rt_ref_frame": scale,
              "points": scale, "calobject_warp": 1e-3}
    for k, s in scales.items():
        a = oi.get(k)
        if a is not None and np.asarray(a).size:
            a = np.asarray(a, dtype=np.float64)
            oi[k] = a + rng.normal(0.0, s, a.shape)
    if perturb_intrinsics:
        a = np.asarray(oi["intrinsics"], np.float64)
        oi["intrinsics"] = a * (1 + rng.normal(0.0, 2e-3, a.shape))
    return oi


def _bench_board(**mk):
    """A bench board configuration: outlier rejection off, as the bench
    runs it, and unperturbed."""
    oi = make_problem(**mk, device=_CPU)[0]
    oi["do_apply_outlier_rejection"] = False
    return oi


def opencv8_1cam():
    """The bench's opencv8_1cam optimization_inputs."""
    return _bench_board(**OPENCV8_1CAM)


def opencv8_4cam():
    """The bench's opencv8_4cam optimization_inputs."""
    return _bench_board(**OPENCV8_4CAM)


def cahvor_1cam():
    """opencv8_1cam's problem with the CAHVOR model: the axis and radial
    terms start at 0 (a pinhole) and the observations come from that
    model."""
    return _bench_board(**CAHVOR_1CAM)


def cahvore_1cam():
    """opencv8_1cam's problem with the CAHVORE model at linearity 0.37,
    its distortions starting at 0."""
    return _bench_board(**CAHVORE_1CAM)


def splined_30x18():
    """The bench's splined_30x18 optimization_inputs: the control points
    start at 0 (a plain stereographic projection) and the observations
    come from that model."""
    return _bench_board(**SPLINED_30X18)


def _rig16_frames(Nframes):
    """Board poses visible to the whole 4x4 rig (bench._rig16_frames):
    mild tilts, 1.2-1.6 m out, a modest lateral sweep."""
    rng = np.random.default_rng(7)
    return np.concatenate([
        rng.normal(0.0, 0.1, (Nframes, 3)),
        np.array([[0.25, 0.2, 1.4]]) + rng.normal(0.0, 0.12, (Nframes, 3)),
    ], axis=1)


def rig16cam():
    """The bench's rig16cam optimization_inputs (outlier rejection off),
    unperturbed."""
    ext = np.array([[0.01 * (i % 4), 0.01 * (i // 4), 0.0,
                     -0.15 * (i % 4), -0.15 * (i // 4), 0.0]
                    for i in range(1, 16)])
    return _bench_board(**RIG16CAM, extrinsics_rt_fromref=ext,
                        frames_rt_toref=_rig16_frames(RIG16CAM["Nframes"]))


def sfm_triangulated(Ncameras=8, Npoints=500):
    """The bench's sfm_triangulated optimization_inputs (bench.py
    _sfm_config), unperturbed: PINHOLE cameras of 1600x1000 on a
    non-collinear trajectory, camera 0 at the reference and camera 1 at
    distance 1 (the scale that unity_cam01 holds), and points seen by two
    or more cameras, observed with 0.1 px of noise.  The intrinsics are
    fixed, the points are triangulated (not in the state), and outlier
    rejection is off.  At the default size: 492 points, 3527
    observations, Nmeasurements 11443, Nstate 42.  Smaller Ncameras and
    Npoints give smaller problems of the same kind."""
    np.random.seed(0)
    model = "LENSMODEL_PINHOLE"
    W, H = 1600, 1000
    intr = np.array([[800., 800., (W - 1) / 2, (H - 1) / 2]])
    rt_true = np.zeros((Ncameras, 6))
    for i in range(1, Ncameras):
        rt_true[i] = [0.02 * i, -0.05 * i, 0.01 * i,
                      -0.4 * i, 0.08 * np.sin(i), 0.05 * i]
    rt_true[1:, 3:] /= np.linalg.norm(rt_true[1, 3:])
    pts = np.stack([np.random.uniform(-6, 6, Npoints),
                    np.random.uniform(-3, 3, Npoints),
                    np.random.uniform(5.0, 25.0, Npoints)], axis=-1)
    p_cam = _transform_point_rt(torch.as_tensor(rt_true[:, None, :]),
                                torch.as_tensor(pts[None]))  # (Ncam,Npts,3)
    q_all = project_core(p_cam, torch.as_tensor(intr[0]), model).numpy()
    p_cam = p_cam.numpy()
    vis = ((q_all[..., 0] >= 0) & (q_all[..., 0] <= W - 1)
           & (q_all[..., 1] >= 0) & (q_all[..., 1] <= H - 1)
           & (p_cam[..., 2] > 0))                            # (Ncam,Npts)
    obs, idx = [], []
    for ip in np.nonzero(vis.sum(axis=0) >= 2)[0]:
        for ic in np.nonzero(vis[:, ip])[0]:
            q = q_all[ic, ip]
            obs.append([q[0] + np.random.randn() * 0.1,
                        q[1] + np.random.randn() * 0.1, 1.0])
            idx.append([ip, 0, ic - 1])
    return dict(
        intrinsics=intr,
        extrinsics_rt_fromref=rt_true[1:].copy(),
        observations_point_triangulated=np.array(obs),
        indices_point_triangulated_camintrinsics_camextrinsics=np.array(
            idx, dtype=np.int32),
        lensmodel=model,
        imagersizes=np.array([[W, H]]),
        do_optimize_intrinsics_core=False,
        do_optimize_intrinsics_distortions=False,
        do_apply_regularization_unity_cam01=True,
        do_apply_outlier_rejection=False,
    )


def _stereo_opencv8_2cam_models(model):
    """stereo_opencv8_2cam's two true cameramodels, drawn after
    np.random.seed(0) (the recipe's draws that come before its boards)."""
    cfg = STEREO_OPENCV8_2CAM
    Nc = cfg["Ncameras"]
    np.random.seed(0)
    imagersize = np.array([800, 600])
    n = lensmodel_num_params(model)
    intr = []
    for i in range(Nc):
        fx = 750.0 + 20 * i
        intr.append([fx, fx * 0.995, (imagersize[0] - 1) / 2 + 5 - 3 * i,
                     (imagersize[1] - 1) / 2 - 4 + 2 * i]
                    + (np.random.randn(n - 4) * 1e-2).tolist())
    intr = np.array(intr)
    ext = np.array([[0.01 * i, -0.02 * i, 0.005 * i,
                     -cfg["rig_spacing"] * i, 0.02 * i, 0.01 * i]
                    for i in range(1, Nc)])
    return [cameramodel(intrinsics=(model, intr[i]), imagersize=imagersize,
                        rt_cam_ref=ext[i - 1] if i else np.zeros(6))
            for i in range(Nc)]


def stereo_opencv8_2cam_truth(Nframes=84, model="LENSMODEL_OPENCV8", W=14,
                              H=14, *, device=None):
    """The true geometry of stereo_opencv8_2cam (the same draws from the
    recipe's seed): dict of the two cameras' intrinsics (2, N) and their
    cameramodels, camera 1's extrinsics rt_cam_ref (1, 6), the boards'
    Rt_ref_boardref (Nframes, 4, 3) and their exact projections q
    (Nframes, 2, H, W, 2), the warp and the spacing.  The projections run
    on `device` (the card unless given "cpu"); the output is numpy."""
    cfg = STEREO_OPENCV8_2CAM
    models = _stereo_opencv8_2cam_models(model)
    intr = np.stack([m.intrinsics()[1] for m in models])
    ext = np.stack([m.extrinsics_rt_fromref() for m in models[1:]])
    imagersize = models[0].imagersize()
    q, Rt_ref_boardref = synthetic_data.synthesize_board_observations(
        models, object_width_n=W, object_height_n=H,
        object_spacing=cfg["spacing"], calobject_warp=np.array(cfg["warp"]),
        rt_ref_boardcenter=np.array([0., 0., 0., 0., 0., 1.2]),
        rt_ref_boardcenter__noiseradius=np.array(
            [np.pi / 6, np.pi / 6, np.pi / 9, 0.2, 0.2, 0.4]),
        Nframes=Nframes, which="all-cameras-must-see-full-board",
        device=device)
    return dict(intrinsics=intr, models=models, extrinsics_rt_fromref=ext,
                Rt_ref_boardref=Rt_ref_boardref, q=q, lensmodel=model,
                imagersize=imagersize, warp=np.array(cfg["warp"]),
                spacing=cfg["spacing"])


def stereo_opencv8_2cam(Nframes=84, model="LENSMODEL_OPENCV8", W=14, H=14,
                        *, device=None):
    """The stereo_opencv8_2cam optimization_inputs: the JAX package's test
    scene (``tests/test_calibration.py`` make_scene) of two cameras of
    800x600, fx 750 and 770, their distortions randn * 1e-2, camera 1 at
    the recipe's extrinsics; ``synthesize_board_observations`` draws
    Nframes poses of a W x H board around 1.2 m that both cameras see
    whole (stereo_opencv8_2cam_truth), the observations are the true
    geometry's projections with 0.3 px of noise, and the geometry is
    perturbed as ``perturbed_oi(seed=1)``, outlier rejection off.  Fewer
    frames, a smaller board or another lens model give smaller problems of
    the same kind.  The projections run on `device` (the card unless given
    "cpu"); the output is numpy."""
    t = stereo_opencv8_2cam_truth(Nframes, model, W, H, device=device)
    q, Nc = t["q"], len(t["models"])
    oi = dict(
        intrinsics=t["intrinsics"],
        extrinsics_rt_fromref=t["extrinsics_rt_fromref"],
        frames_rt_toref=_rt_from_Rt(torch.as_tensor(
            t["Rt_ref_boardref"])).numpy(),
        observations_board=np.concatenate(
            [q, np.ones(q.shape[:-1] + (1,))], axis=-1).reshape(
                Nframes * Nc, H, W, 3),
        indices_frame_camintrinsics_camextrinsics=np.array(
            [[f, c, c - 1] for f in range(Nframes) for c in range(Nc)],
            dtype=np.int32),
        lensmodel=model, imagersizes=np.tile(t["imagersize"], (Nc, 1)),
        calobject_warp=t["warp"].copy(),
        calibration_object_spacing=t["spacing"])
    make_perfect_observations(oi, observed_pixel_uncertainty=0.3,
                              device=device)
    oi = perturbed_oi(oi, seed=1)
    oi["do_apply_outlier_rejection"] = False
    return oi


def sfm_points(Nobservations_total=60000, Nobservations_image=150,
               noise_px=0.3, Npoints_fixed=4, seed=0, *, device=None):
    """The sfm_points optimization_inputs: SfM with discrete points in the
    state (mrcal's test-sfm-fixed-points).  Camera 0 of
    stereo_opencv8_2cam (LENSMODEL_OPENCV8, 800x600, fx 750) flies the
    library's default track of ``synthetic_data.make_tracks`` (100 m up, a
    frame each 20 m); the points and frames that have observations are
    kept, in their order.  Frame 0 is the reference; the others' extrinsics
    are rt_cam_ref = rt(Rt_cam_NED Rt_NED_cam0), and the points are in the
    reference.  The observations get N(0, noise_px) noise from
    np.random.default_rng(seed), weight 1.  The last Npoints_fixed points
    are fixed (mrcal requires them last); the intrinsics are fixed and
    outlier rejection is off.  The geometry is perturbed by
    perturbed_oi(seed=1)'s draws, the extrinsics' on each frame's pose
    rt_ref_cam, and the fixed points are put back at the truth.  The
    projections run on `device` (the card unless given "cpu"); the output
    is numpy.

    Returns (optimization_inputs, truth): truth holds the true points (N,
    3) and extrinsics_rt_fromref (Nframes - 1, 6)."""
    m = _stereo_opencv8_2cam_models("LENSMODEL_OPENCV8")[0]
    q, idx, points, Rt_NED_cam = synthetic_data.make_tracks(
        m, Nobservations_total=Nobservations_total,
        Nobservations_image=Nobservations_image, device=device)
    ipoints, ip = np.unique(idx[:, 0], return_inverse=True)
    icams, ic = np.unique(idx[:, 1], return_inverse=True)
    Rt_NED_cam = torch.as_tensor(Rt_NED_cam[icams])
    Rt_cam0_NED = _invert_Rt(Rt_NED_cam[0])
    ext = _rt_from_Rt(_compose_Rt2(_invert_Rt(Rt_NED_cam[1:]),
                                   Rt_NED_cam[0])).numpy()
    points = _transform_point_Rt(Rt_cam0_NED,
                                 torch.as_tensor(points[ipoints])).numpy()
    rng = np.random.default_rng(seed)
    q = q + rng.normal(0.0, noise_px, q.shape)
    lens, intr = m.intrinsics()
    oi = dict(
        intrinsics=intr[None].copy(),
        extrinsics_rt_fromref=ext,
        points=points,
        observations_point=np.concatenate([q, np.ones((len(q), 1))], axis=1),
        indices_point_camintrinsics_camextrinsics=np.stack(
            [ip, np.zeros_like(ip), ic - 1], axis=1).astype(np.int32),
        lensmodel=lens,
        imagersizes=m.imagersize()[None].copy(),
        Npoints_fixed=Npoints_fixed,
        do_optimize_intrinsics_core=False,
        do_optimize_intrinsics_distortions=False,
        do_apply_outlier_rejection=False)
    truth = dict(points=points, extrinsics_rt_fromref=ext)
    # perturbed_oi's draws go onto each frame's pose rt_ref_cam (its
    # attitude and position), as a navigation prior's errors would: added
    # to rt_cam_ref, a rotation draw turns a frame about the reference,
    # which moves one d m away by ~0.01 d m (tens of m over the track)
    oi["extrinsics_rt_fromref"] = _invert_rt(torch.as_tensor(ext)).numpy()
    oi = perturbed_oi(oi, seed=1)
    oi["extrinsics_rt_fromref"] = _invert_rt(
        torch.as_tensor(oi["extrinsics_rt_fromref"])).numpy()
    if Npoints_fixed:
        oi["points"][-Npoints_fixed:] = points[-Npoints_fixed:]
    return oi, truth
