"""Helpers of the port's tests for their JAX references, in a module that
imports neither torch nor the port: the processes that compute JAX
references (jax_reference_pool) run functions of this module, and start
without torch's import.
"""

import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor

import numpy as np


def share_jax_evaluations(directory=None):
    """In a process that computes JAX references: make the JAX package's
    optimizer_callback and drt_cross_reprojection__dbpacked return a copy
    of their first result for inputs with the same contents.  Its
    uncertainty code calls each of them once per call of its own, on the
    same solve, and each call costs seconds of eager dispatch and
    compiles; the results are those of the first call, bit for bit.  With
    a directory, the processes given it share their results: each is
    written there too, and read from there by a process that has not
    computed it yet."""
    import copy
    import functools
    import hashlib
    import pickle
    import mrcal_tpu.optimize.residuals

    def key(args, kw):
        h = hashlib.sha1()
        for k, v in [(None, a) for a in args] + sorted(kw.items()):
            h.update(repr(k).encode())
            if isinstance(v, np.ndarray):
                h.update(repr((v.shape, v.dtype)).encode())
                h.update(np.ascontiguousarray(v).tobytes())
            else:
                h.update(repr(v).encode())
        return h.hexdigest()

    def shared(fn):
        cache = {}

        @functools.wraps(fn)
        def call(*args, **kw):
            k = key(args, kw)
            path = directory and os.path.join(directory, k)
            if k in cache:
                pass
            elif path and os.path.exists(path):
                with open(path, "rb") as f:
                    cache[k] = pickle.load(f)
            else:
                cache[k] = fn(*args, **kw)
                if path:
                    with open(f"{path}.{os.getpid()}", "wb") as f:
                        pickle.dump(cache[k], f)
                    os.replace(f"{path}.{os.getpid()}", path)
            return copy.deepcopy(cache[k])
        return call

    # (the package's `optimize` attribute is the function of that name)
    for module, name in (("mrcal_tpu.optimize", "optimizer_callback"),
                         ("mrcal_tpu.optimize.residuals",
                          "drt_cross_reprojection__dbpacked")):
        module = sys.modules[module]
        setattr(module, name, shared(getattr(module, name)))


# XLA's backend flags for the processes that compute JAX references: they
# compile hundreds of small programs and run each once or a few times, so
# the backend's optimizations cost more compile time than they save
JAX_REFERENCE_XLA_FLAGS = ("--xla_backend_optimization_level=0 "
                           "--xla_llvm_disable_expensive_passes=true")


def compile_jax_transforms():
    """In a process that computes JAX references: make the JAX package
    compile the Jacobians of its uncertainty and triangulation code as
    one program each (the results of jax.jacrev and jax.vmap in its
    triangulation module, of jax.jacrev in model_analysis, and of
    jax.vmap and jax.jacfwd in its residuals module: J's per-observation
    blocks and drt's Jcross).  The same functions, evaluated by XLA at
    once instead of one eager operation at a time, in about a fifth less
    time; the results move by ~1e-12 of the largest entry."""
    import jax
    import mrcal_tpu.model_analysis
    import mrcal_tpu.triangulation

    class Compiled:
        """jax, with the results of the named transforms jitted."""

        def __init__(self, *names):
            self.names = names

        def __getattr__(self, name):
            transform = getattr(jax, name)
            if name not in self.names:
                return transform
            return lambda f, **kw: jax.jit(transform(f, **kw))
    mrcal_tpu.triangulation.jax = Compiled("vmap", "jacrev")
    mrcal_tpu.model_analysis.jax = Compiled("jacrev")
    sys.modules["mrcal_tpu.optimize.residuals"].jax = Compiled("vmap",
                                                              "jacfwd")


def jax_reference_pool(n, compiled=True):
    """n spawned processes for JAX references, all started now with
    JAX_REFERENCE_XLA_FLAGS (and compile_jax_transforms() run first in
    each, if `compiled`): a ProcessPoolExecutor, to be used as a context
    manager.  A spawn context starts a process per submit while none is
    idle: n submits made now start all n."""
    pool = ProcessPoolExecutor(
        n, mp_context=multiprocessing.get_context("spawn"),
        initializer=compile_jax_transforms if compiled else None)
    flags = os.environ.get("XLA_FLAGS")
    os.environ["XLA_FLAGS"] = " ".join(
        f for f in (flags, JAX_REFERENCE_XLA_FLAGS) if f)
    try:
        for _ in range(n):
            pool.submit(int)
    finally:
        if flags is None:
            del os.environ["XLA_FLAGS"]
        else:
            os.environ["XLA_FLAGS"] = flags
    return pool


# ----------------------------------------------------------------------------
# tests/test_torch_uncertainty.py
# ----------------------------------------------------------------------------

def uncertainty_references(problems, p_cam, rt_cc):
    """The JAX package on each problem of `problems` (name ->
    (optimization_inputs, the queried camera, its methods, the pixel noise
    given to projection_uncertainty or None)) at the camera-frame points
    p_cam: covariances for every method and distance, drt for the queried
    camera and the rrp flavor; on 1cam, the what= variants of mean-pcam
    through the API too, and on 2cam residuals_cross at rt_cc."""
    import mrcal_tpu
    from mrcal_tpu.model_analysis import worst_direction_stdev
    share_jax_evaluations()
    refs = {}
    for name, (oi, icam, methods, sigma) in problems.items():
        m = mrcal_tpu.cameramodel(optimization_inputs=oi,
                                  icam_intrinsics=icam)
        out = refs[name] = dict(cov={}, what={}, drt={})
        for method in methods:
            for atinfinity in (False, True):
                cov = np.asarray(mrcal_tpu.projection_uncertainty(
                    p_cam, m, method=method, atinfinity=atinfinity,
                    observed_pixel_uncertainty=sigma))
                out["cov"][method, atinfinity] = cov
                l = np.linalg.eigvalsh(cov)
                out["what"][method, atinfinity] = {
                    "worstdirection-stdev": np.asarray(
                        worst_direction_stdev(cov)),
                    "rms-stdev": np.sqrt(np.mean(l, axis=-1))}
        if name == "1cam":
            for what in ("worstdirection-stdev", "rms-stdev"):
                out["what"]["mean-pcam", False][what] = np.asarray(
                    mrcal_tpu.projection_uncertainty(p_cam, m, what=what))
        for ic in (icam, -1):
            if ic < 0 and name == "moving":
                continue
            out["drt"][ic] = mrcal_tpu.drt_cross_reprojection__dbpacked(
                icam_intrinsics=ic, **oi)
        if name == "2cam":
            out["residuals_cross"] = residuals_cross_cases(
                "jax", oi, rt_cc, np.asarray)
    return refs


def residuals_cross_cases(pkg, oi, rt_cc, to_numpy):
    """pkg's ("jax" or "port") residuals_cross of oi at rt_cc in its three
    flavors: rrp, ccp with the query camera's extrinsics given, ccp per
    observation."""
    if pkg == "jax":
        from mrcal_tpu.optimize import residuals as res
        from mrcal_tpu.optimize.layout import normalize_inputs as norm
        from mrcal_tpu.optimize.layout import spec_from_inputs as spec_of
        kw = norm(oi)
        arrays = res.arrays_from_inputs(**kw)
        spec = spec_of(**kw)
        as_array = np.asarray
    else:
        import torch
        from mrcal_tpu_torch.optimize import residuals as res
        from mrcal_tpu_torch.optimize.layout import spec_from_inputs
        kw = oi
        arrays = res.arrays_from_inputs(oi, device="cpu")
        spec = spec_from_inputs(**oi)
        as_array = torch.as_tensor
    b = res.pack_params(res.params_from_arrays(arrays), spec)
    rt = as_array(rt_cc)
    ext = as_array(np.asarray(kw["extrinsics_rt_fromref"])[0])
    return {flavor: to_numpy(res.residuals_cross(rt, b, arrays, spec, **f))
            for flavor, f in (("rrp", {}),
                              ("ccp stationary", dict(rt_cam_star_ref=ext)),
                              ("ccp per observation",
                               dict(ccp_per_observation=True)))}


# ----------------------------------------------------------------------------
# tests/test_torch_triangulate.py
# ----------------------------------------------------------------------------

def moving_oi(oi):
    """oi with camera 1 observed under two extrinsics."""
    oi = dict(oi)
    idx = oi["indices_frame_camintrinsics_camextrinsics"].copy()
    idx[(idx[:, 1] == 1) & (idx[:, 0] % 2 == 1), 2] = 1
    oi["indices_frame_camintrinsics_camextrinsics"] = idx
    oi["extrinsics_rt_fromref"] = np.concatenate(
        [oi["extrinsics_rt_fromref"]] * 2)
    return oi


def raising_calls(pkg, oi, q, **kw):
    """name -> a call of pkg.triangulate (with kw) that the JAX package
    refuses."""
    m0, m1 = (pkg.cameramodel(optimization_inputs=oi, icam_intrinsics=i)
              for i in (0, 1))
    bare = [pkg.cameramodel(intrinsics=m.intrinsics(),
                            imagersize=m.imagersize(),
                            rt_cam_ref=m.rt_cam_ref()) for m in (m0, m1)]
    moving = [pkg.cameramodel(optimization_inputs=moving_oi(oi),
                              icam_intrinsics=i) for i in (0, 1)]
    def call(models, **k):
        return lambda: pkg.triangulate(q, models, **k, **kw)
    return {
        "negative calibration stdev": call((m0, m1),
                                           q_calibration_stdev=-1),
        "negative observation stdev": call((m0, m1),
                                           q_observation_stdev=-1),
        "lindstrom with a stdev": call(
            (m0, m1), method=pkg.triangulate_lindstrom,
            q_observation_stdev=0.2),
        "no optimization_inputs": call(bare, q_calibration_stdev=0.3),
        "moving camera": call(moving, q_calibration_stdev=0.3),
    }


def triangulate_references(refs, oi, q, shared):
    """The JAX package's triangulate() on q for each reference of refs
    (name -> (method, keyword arguments)), in order, numpy; "raises":
    which of raising_calls() raise, and its p, its calls with a stdev of 0
    and its triangulate_lindstrom of the local rays.  The processes given
    the same directory `shared` share their Jacobians of oi."""
    import mrcal_tpu
    share_jax_evaluations(shared)
    models = [mrcal_tpu.cameramodel(optimization_inputs=oi,
                                    icam_intrinsics=i) for i in (0, 1)]
    out = {}
    for name, ref in refs.items():
        if name == "raises":
            raised = {}
            for what, fn in raising_calls(mrcal_tpu, oi, q).items():
                try:
                    fn()
                    raised[what] = False
                except Exception:
                    raised[what] = True
            m0, m1 = models
            v0 = mrcal_tpu.unproject(q[..., 0, :], *m0.intrinsics())
            v1 = mrcal_tpu.unproject(q[..., 1, :], *m1.intrinsics())
            Rt01 = mrcal_tpu.compose_Rt(m0.Rt_cam_ref(),
                                        mrcal_tpu.invert_Rt(m1.Rt_cam_ref()))
            out["raises"] = dict(
                raised=raised,
                p=np.asarray(mrcal_tpu.triangulate(q, models)),
                zero=[np.asarray(a) for a in mrcal_tpu.triangulate(
                    q, models, q_calibration_stdev=0,
                    q_observation_stdev=0)],
                lindstrom=np.asarray(
                    mrcal_tpu.triangulate_lindstrom(v0, v1, Rt01)))
            continue
        method, kw = ref
        if isinstance(method, tuple):
            # each method on its own copy of the points, in one call
            qm = np.concatenate([q.reshape(-1, 2, 2)] * len(method))
            method = each_method(method, len(qm) // len(method))
        else:
            qm = q
            method = getattr(mrcal_tpu, "triangulate_" + method)
        out[name] = [np.asarray(a) for a in mrcal_tpu.triangulate(
            qm, models, method=method, **kw)]
    return out


def each_method(names, n):
    """A triangulation method for triangulate() that gives points k*n to
    (k+1)*n to the JAX package's triangulate_<names[k]>: one call of
    triangulate() (one compile of its Jacobians) covers several methods,
    each on its own copy of the points, and each copy's block of
    Var_p_calibration is that method's."""
    import jax.numpy as jnp
    import mrcal_tpu
    methods = [getattr(mrcal_tpu, "triangulate_" + m) for m in names]

    def method(v0, v1, t01):
        t01 = jnp.broadcast_to(t01, v1.shape)
        return jnp.concatenate([
            m(v0[k * n:(k + 1) * n], v1[k * n:(k + 1) * n],
              t01[k * n:(k + 1) * n]) for k, m in enumerate(methods)])
    return method




# ----------------------------------------------------------------------------
# tests/test_torch_detector.py
# ----------------------------------------------------------------------------

def _nonsquare_scene():
    """tests/test_detector.py::test_nonsquare_grid's scene: 14 x 10 cells
    through a homography, 13 x 9 inner corners."""
    Hmat = np.array([[26.0, 1.0, 60.0], [-1.0, 27.0, 45.0], [0.0, 0.0, 1.0]])
    ss, H_img, W_img = 4, 330, 440
    ysg, xsg = np.mgrid[0:H_img * ss, 0:W_img * ss].astype(np.float64)
    xsg = (xsg + 0.5) / ss - 0.5
    ysg = (ysg + 0.5) / ss - 0.5
    Hinv = np.linalg.inv(Hmat)
    w = Hinv[2, 0] * xsg + Hinv[2, 1] * ysg + Hinv[2, 2]
    bx = (Hinv[0, 0] * xsg + Hinv[0, 1] * ysg + Hinv[0, 2]) / w
    by = (Hinv[1, 0] * xsg + Hinv[1, 1] * ysg + Hinv[1, 2]) / w
    inside = (bx >= 0) & (bx < 14) & (by >= 0) & (by < 10)
    checker = ((np.floor(bx).astype(int) + np.floor(by).astype(int)) % 2)
    im = np.where(inside, np.where(checker, 40.0, 220.0), 130.0)
    return im.reshape(H_img, ss, W_img, ss).mean(axis=(1, 3)).astype(
        np.float32), (13, 9)


def detector_scene(name):
    """(image, (gridn_w, gridn_h)) of a detector scene: the scenes of
    tests/test_detector.py (frontal, perspective, noise_blobs, nonsquare),
    a square board that the JAX package numbers as its mirror image
    (mirrored), and a board of large squares under heavy noise, 8-bit,
    that the JAX package finds at pyramid level 1 (noisy_level1) or 2
    (noisy_level2)."""
    from test_detector import render_chessboard
    if name == "nonsquare":
        return _nonsquare_scene()
    if name == "frontal":
        return render_chessboard(450, 480, np.array(
            [[30.0, 0.0, 70.0], [0.0, 30.0, 55.0], [0.0, 0.0, 1.0]]))[0], \
            (10, 10)
    if name == "perspective":
        return render_chessboard(440, 460, np.array(
            [[24.0, -7.0, 160.0], [6.0, 22.0, 60.0],
             [1.2e-4, -9e-5, 1.0]]))[0], (10, 10)
    if name == "mirrored":
        # a square board that the JAX package numbers as its mirror image
        return render_chessboard(440, 460, np.array(
            [[25.0, 5.0, 85.0], [-5.0, 25.0, 90.0], [4e-5, -3e-5, 1.0]]))[0], \
            (10, 10)
    if name == "noise_blobs":
        im = render_chessboard(440, 440, np.array(
            [[27.0, 2.0, 80.0], [-2.0, 26.0, 70.0], [0.0, 0.0, 1.0]]))[0]
        im = im + np.random.default_rng(0).normal(0, 3.0, im.shape).astype(
            np.float32)
        im[10:25, 10:25] = 255.0
        im[400:420, 390:425] = 0.0
        return im, (10, 10)
    sigma = dict(noisy_level1=25.0, noisy_level2=45.0)[name]
    im = render_chessboard(760, 780, np.array(
        [[60.0, 2.0, 90.0], [-2.0, 58.0, 80.0], [0.0, 0.0, 1.0]]))[0]
    im = im + np.random.default_rng(1).normal(0, sigma, im.shape)
    return np.clip(im, 0, 255).astype(np.uint8), (10, 10)


def detector_references(names, responses, files):
    """The JAX package's find_chessboard_corners of each scene of names,
    its chess_response of each scene of responses, 8-bit and float32, and
    its detect_corners_in_images of the image files `files` (10 x 10):
    {("corners", name): (corners, level), ("response", name, "uint8" or
    "float32"): R, "files": detections}."""
    import mrcal_tpu.detector as jd
    out = {}
    if files:
        out["files"] = jd.detect_corners_in_images(files, 10)
    for name in names:
        im, grid = detector_scene(name)
        out["corners", name] = jd.find_chessboard_corners(im, *grid)
    for name in responses:
        im = detector_scene(name)[0]
        for kind, x in (("uint8", np.clip(im, 0, 255).astype(np.uint8)),
                        ("float32", im)):
            out["response", name, kind] = np.asarray(jd.chess_response(x))
    return out


# ----------------------------------------------------------------------------
# tests/test_torch_calibration.py
# ----------------------------------------------------------------------------

# the seeding cases: (make_scene keywords, the lens model and the focal
# scale of the intrinsics given to the monocular PnP: None for the true
# ones)
SEEDING_CASES = {
    "2cam": (dict(Ncameras=2, Nframes=4, W=8, H=6), None),
    "3cam": (dict(Ncameras=3, Nframes=3, W=7, H=5), None),
    # a stereographic guess at 0.4 of the focal length: some observations
    # miss by more than 0.02 (normalized), and the PnP's focal retry runs
    "retry": (dict(Ncameras=1, Nframes=4, W=8, H=6),
              ("LENSMODEL_STEREOGRAPHIC", 0.4)),
}


def seeding_references(name):
    """The JAX package's seeding functions on the seeding case `name`'s
    make_scene scene with 0.2 px of noise: the monocular PnP with the true
    intrinsics (or the case's guess), the camera poses and the joint frame
    poses from it, and seed_stereographic (focal 700).  Returns (the
    scene's arrays, the references)."""
    import mrcal_tpu
    import mrcal_tpu.calibration as jc
    from test_calibration import make_scene
    kw, guess = SEEDING_CASES[name]
    scene = make_scene(model="LENSMODEL_OPENCV4", **kw)
    scene.pop("models")
    obs = scene["observations"]
    np.random.seed(11)
    obs[..., :2] += np.random.randn(*obs[..., :2].shape) * 0.2
    idx = scene["indices"][:, :2]
    Nc = kw["Ncameras"]
    intr = scene["intrinsics_true"]
    models = [(scene["lensmodel"], intr[c]) for c in range(Nc)]
    if guess is not None:
        models = [(guess[0], intr[c, :4] * [guess[1], guess[1], 1, 1])
                  for c in range(Nc)]
    Rt_cf = np.asarray(mrcal_tpu.estimate_monocular_calobject_poses_Rt_tocam(
        idx, obs, scene["spacing"], models))
    refs = dict(models=models, Rt_cf=Rt_cf)
    if Nc > 1:
        refs["Rt_cam_ref"] = np.asarray(
            jc._estimate_camera_poses(Rt_cf, idx, Nc))
        refs["frames"] = np.asarray(mrcal_tpu.estimate_joint_frame_poses(
            Rt_cf, refs["Rt_cam_ref"][1:], idx, kw["W"], kw["H"],
            scene["spacing"]))
        refs["seed"] = [np.asarray(a) for a in mrcal_tpu.seed_stereographic(
            imagersizes=scene["imagersizes"], focal_estimate=700.0,
            indices_frame_camera=idx, observations=obs,
            object_spacing=scene["spacing"])]
    return scene, refs


# the slice's scene: two pinhole cameras of 640 x 480, 0.2 m apart, and
# SLICE_FRAMES poses of a board of 11 x 9 squares (10 x 8 inner corners,
# 0.04 m) about 0.85 m away, rendered 4 x 4 supersampled into 8-bit images
SLICE_FRAMES = 6
SLICE_BOARD = (10, 8, 0.04)
SLICE_IMAGER = (640, 480)
SLICE_K = [np.array([[520.0, 0, 322.0], [0, 518.0, 236.0], [0, 0, 1]]),
           np.array([[540.0, 0, 316.0], [0, 541.0, 243.0], [0, 0, 1]])]
SLICE_RT_CAM1_REF = np.array([0.01, -0.02, 0.005, -0.2, 0.01, 0.005])
SLICE_GLOBS = ("*-cam0.png", "*-cam1.png")


def _R_from_r(r):
    th = np.linalg.norm(r)
    if th < 1e-12:
        return np.eye(3)
    k = r / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def slice_images():
    """The slice's images, {filename: uint8 (480, 640)} named
    frame{f:03d}-cam{c}.png, and the true geometry: rt_cam_ref of camera
    1, rt_ref_frame of each frame (the board's corner (0, 0) at the
    frame's origin, x along its rows)."""
    W, H, spacing = SLICE_BOARD
    Wpx, Hpx = SLICE_IMAGER
    rng = np.random.default_rng(7)
    R1 = _R_from_r(SLICE_RT_CAM1_REF[:3])
    t1 = SLICE_RT_CAM1_REF[3:]
    center = np.array([(W - 1) * spacing / 2, (H - 1) * spacing / 2, 0])
    images, frames = {}, []
    ss = 4
    ys, xs = np.mgrid[0:Hpx * ss, 0:Wpx * ss].astype(np.float64)
    xs = (xs + 0.5) / ss - 0.5
    ys = (ys + 0.5) / ss - 0.5
    for f in range(SLICE_FRAMES):
        r = rng.uniform(-1, 1, 3) * np.array([0.35, 0.35, 0.15])
        t = np.array([0.1, 0.0, 0.85]) + rng.uniform(-1, 1, 3) * \
            np.array([0.04, 0.04, 0.08])
        R = _R_from_r(r)
        t = t - R @ center                 # rotate about the board's center
        frames.append(np.concatenate([r, t]))
        for c, (Rc, tc) in enumerate(((np.eye(3), np.zeros(3)), (R1, t1))):
            Rcb, tcb = Rc @ R, Rc @ t + tc
            # board cells (x / spacing + 1): inner vertex (i, j) at cell
            # coordinate (i + 1, j + 1)
            Hm = SLICE_K[c] @ np.stack(
                [Rcb[:, 0] * spacing, Rcb[:, 1] * spacing,
                 tcb - (Rcb[:, 0] + Rcb[:, 1]) * spacing], axis=1)
            Hinv = np.linalg.inv(Hm)
            w = Hinv[2, 0] * xs + Hinv[2, 1] * ys + Hinv[2, 2]
            bx = (Hinv[0, 0] * xs + Hinv[0, 1] * ys + Hinv[0, 2]) / w
            by = (Hinv[1, 0] * xs + Hinv[1, 1] * ys + Hinv[1, 2]) / w
            inside = (bx >= 0) & (bx < W + 1) & (by >= 0) & (by < H + 1)
            checker = (np.floor(bx).astype(int)
                       + np.floor(by).astype(int)) % 2
            im = np.where(inside, np.where(checker, 40.0, 220.0), 130.0)
            im = im.reshape(Hpx, ss, Wpx, ss).mean(axis=(1, 3))
            images[f"frame{f:03d}-cam{c}.png"] = np.round(im).astype(np.uint8)
    return images, SLICE_RT_CAM1_REF, np.array(frames)


def slice_optimization_inputs(obs, idx_fc, seed):
    """The staged solves' optimization_inputs from the seed: OPENCV4, the
    seeded core with zero distortions, the seeded geometry, no warp."""
    intr_seed, ext_seed, frames_seed = seed
    return dict(
        intrinsics=np.concatenate(
            [intr_seed, np.zeros((len(intr_seed), 4))], axis=1),
        extrinsics_rt_fromref=ext_seed.copy(),
        frames_rt_toref=frames_seed.copy(),
        observations_board=obs.copy(),
        indices_frame_camintrinsics_camextrinsics=np.concatenate(
            [idx_fc, idx_fc[:, 1:] - 1], axis=1).astype(np.int32),
        lensmodel="LENSMODEL_OPENCV4",
        imagersizes=np.tile(np.array(SLICE_IMAGER), (2, 1)),
        calobject_warp=np.zeros(2),
        calibration_object_spacing=SLICE_BOARD[2],
        do_apply_outlier_rejection=False)


SLICE_STAGE1 = dict(do_optimize_intrinsics_core=False,
                    do_optimize_intrinsics_distortions=False,
                    do_optimize_calobject_warp=False)


def slice_references():
    """The JAX package's calibration front end on the slice's images
    (slice_images()): each image's detection, the corners.vnl text and
    compute_chessboard_corners' arrays, seed_stereographic (focal 500),
    the two staged optimize() calls (geometry, then everything), and the
    valid-intrinsics region of camera 0."""
    import io
    import mrcal_tpu
    import mrcal_tpu.calibration as jc
    from mrcal_tpu.detector import find_chessboard_corners
    W, H, spacing = SLICE_BOARD
    images = slice_images()[0]
    out = dict(detections={})
    lines = ["# filename x y level\n"]
    for fname, im in images.items():
        corners, level = find_chessboard_corners(im, W, H)
        out["detections"][fname] = (corners, level)
        if corners is None:
            lines.append(f"{fname} - - -\n")
            continue
        for x, y in corners:
            lines.append(f"{fname} {x:.5f} {y:.5f} {level}\n")
    out["vnl"] = "".join(lines)
    obs, idx_fc, paths = mrcal_tpu.compute_chessboard_corners(
        W, H, globs_per_camera=SLICE_GLOBS,
        corners_cache_vnl=io.StringIO(out["vnl"]))
    out["corners"] = (obs, idx_fc, paths)
    seed = [np.asarray(a) for a in mrcal_tpu.seed_stereographic(
        imagersizes=np.tile(np.array(SLICE_IMAGER), (2, 1)),
        focal_estimate=500.0, indices_frame_camera=idx_fc,
        observations=obs, object_spacing=spacing)]
    out["seed"] = seed
    oi = slice_optimization_inputs(obs, idx_fc, seed)
    for stage, extra in (("stage1", SLICE_STAGE1), ("stage2", {})):
        stats = mrcal_tpu.optimize(**dict(oi, **extra))
        out[stage] = dict(rms=stats["rms_reproj_error__pixels"],
                          b=np.asarray(stats["b_packed"]),
                          intrinsics=oi["intrinsics"].copy(),
                          extrinsics=oi["extrinsics_rt_fromref"].copy())
    model = mrcal_tpu.cameramodel(optimization_inputs=oi, icam_intrinsics=0)
    out["region"] = np.asarray(jc._compute_valid_intrinsics_region(model))
    return out


# ----------------------------------------------------------------------------
# tests/test_torch_image_transforms.py, tests/test_torch_stereo.py and
# tests/test_torch_stereo_sgm.py
# ----------------------------------------------------------------------------

# two OPENCV8 cameras of 160 x 120, camera 1 0.2 m to the right of camera 0
# and slightly turned; cam1_region is camera 1 with a valid-intrinsics
# region; pin0 and pin1 are the two as PINHOLE cameras; skew1 is a PINHOLE
# camera 0.2 m right of and 0.2 m ahead of camera 0 (the baseline 45
# degrees off the optical axis)
_OPENCV8 = [150.0, 148.0, 80.5, 59.0, -0.05, 0.01, 1e-3, -5e-4, 2e-3,
            1e-3, -2e-3, 5e-4]
DENSE_MODELS = {
    "cam0": dict(intrinsics=("LENSMODEL_OPENCV8", _OPENCV8),
                 imagersize=(160, 120), rt_cam_ref=np.zeros(6)),
    "cam1": dict(intrinsics=("LENSMODEL_OPENCV8",
                             [153.0, 151.0, 78.0, 61.5] + _OPENCV8[4:]),
                 imagersize=(160, 120),
                 rt_cam_ref=np.array([0.01, -0.02, 0.005, -0.2, 0.003,
                                      0.01])),
    "skew1": dict(intrinsics=("LENSMODEL_PINHOLE",
                              [150.0, 150.0, 79.5, 59.5]),
                  imagersize=(160, 120),
                  rt_cam_ref=np.array([0., 0., 0., -0.2, 0., -0.2])),
}
DENSE_MODELS["pin0"] = dict(DENSE_MODELS["cam0"], intrinsics=(
    "LENSMODEL_PINHOLE", _OPENCV8[:4]))
DENSE_MODELS["pin1"] = dict(DENSE_MODELS["cam1"], intrinsics=(
    "LENSMODEL_PINHOLE", DENSE_MODELS["cam1"]["intrinsics"][1][:4]))
DENSE_MODELS["cam1_region"] = dict(
    DENSE_MODELS["cam1"],
    valid_intrinsics_region=np.array([[12.3, 9.7], [147.1, 14.2],
                                      [151.6, 108.9], [20.4, 104.1],
                                      [12.3, 9.7]]))


def dense_texture(shape, seed, blur=1.0, scale=4.0):
    """Band-limited noise: tests/test_stereo_sgm.py's _texture."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    return gaussian_filter(
        rng.uniform(0, 255, shape).astype(np.float32), blur) * scale


def remap_coordinates(shape, seed):
    """A float32 (H, W, 2) map of source (x, y) into a 160 x 120 image: a
    smooth warp reaching past each edge, and a few masked (-1, -1)
    entries."""
    H, W = shape
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    mx = x * 170.0 / W - 5 + 3 * np.sin(y / 7.0) + rng.uniform(-.5, .5, x.shape)
    my = y * 130.0 / H - 5 + 3 * np.cos(x / 9.0) + rng.uniform(-.5, .5, x.shape)
    m = np.stack([mx, my], axis=-1).astype(np.float32)
    m[rng.random((H, W)) < 0.02] = -1.0
    return m


def half_level_case():
    """A uint8 image whose neighbours differ by odd amounts, sampled half
    way between columns: every sample lies on .5 of a level."""
    rng = np.random.default_rng(5)
    im = (rng.integers(0, 127, (20, 30)) * 2).astype(np.uint8)
    im[:, 1::2] += 1
    y, x = np.mgrid[0:20, 0:29].astype(np.float32)
    return im, np.stack([x + 0.5, y], axis=-1)


def dense_resolve(pkg, arg, kw):
    """A case argument in package pkg: ("model", key), ("pair", k0, k1),
    ("pinhole", key, fit) and ("rect", k0, k1, rectified_system kwargs)
    become that package's objects (kw: the port's device=)."""
    if not (isinstance(arg, tuple) and arg and isinstance(arg[0], str)):
        return arg
    what = arg[0]
    if what == "model":
        return pkg.cameramodel(**DENSE_MODELS[arg[1]])
    if what == "pair":
        return tuple(pkg.cameramodel(**DENSE_MODELS[k]) for k in arg[1:])
    if what == "pinhole":
        return pkg.pinhole_model_for_reprojection(
            pkg.cameramodel(**DENSE_MODELS[arg[1]]), arg[2], **kw)
    if what == "rect":
        return pkg.rectified_system(
            dense_resolve(pkg, ("pair",) + arg[1:3], kw), **arg[3], **kw)
    return arg


def dense_numpy(x):
    """A result as numpy: arrays and tensors, cameramodels as dicts, the
    rest as it is, through tuples, lists and dicts."""
    if hasattr(x, "intrinsics") and hasattr(x, "imagersize"):
        return dict(lensmodel=x.intrinsics()[0],
                    intrinsics=np.asarray(x.intrinsics()[1]),
                    imagersize=np.asarray(x.imagersize()),
                    rt_cam_ref=np.asarray(x.extrinsics_rt_fromref()))
    if isinstance(x, (tuple, list)):
        return [dense_numpy(v) for v in x]
    if isinstance(x, dict):
        return {k: dense_numpy(v) for k, v in x.items()}
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    if hasattr(x, "__array__") and not isinstance(x, np.ndarray):
        return np.asarray(x)
    return x


def dense_call(pkg, case, kw):
    """Case (function name, args, kwargs) called in package pkg: its
    result as numpy, or ("raises", the exception's message)."""
    fn, args, kwargs = case
    args = [dense_resolve(pkg, a, kw) for a in args]
    try:
        return dense_numpy(getattr(pkg, fn)(*args, **kwargs, **kw))
    except Exception as e:      # the message is what the test compares
        return ("raises", str(e))


def dense_references(cases):
    """The JAX package on each case of `cases` (name -> (function name,
    args, kwargs)): name -> result (dense_call)."""
    import mrcal_tpu
    return {name: dense_call(mrcal_tpu, case, {})
            for name, case in cases.items()}


# the SGM cases: (images, disparity_min, disparity_max,
# lr_consistency_threshold)
SGM_SHAPE = (64, 96)


def sgm_pair(kind):
    """A rectified pair of SGM_SHAPE: "plane" a textured plane at
    disparity 9; "box" a plane at 6 with a box at 17 in front of it;
    "colour" the box scene as 3-channel uint8 images; "flat" the plane
    with large flat patches (ties in every cost)."""
    H, W = SGM_SHAPE
    if kind == "plane":
        tex = dense_texture((H, W + 48), 11)
        return tex[:, 24:24 + W], tex[:, 24 + 9:24 + 9 + W]
    if kind in ("box", "colour"):
        tex_bg = dense_texture((H, W + 48), 12)
        tex_fg = dense_texture((H, W + 48), 13)
        y0, y1, x0, x1 = 16, 48, 40, 76
        im0 = tex_bg[:, 24:24 + W].copy()
        im0[y0:y1, x0:x1] = tex_fg[:, 24:24 + W][y0:y1, x0:x1]
        im1 = tex_bg[:, 24 + 6:24 + 6 + W].copy()
        fg = tex_fg[:, 24 + 17:24 + 17 + W]
        im1[y0:y1, x0 - 17:x1 - 17] = fg[y0:y1, x0 - 17:x1 - 17]
        if kind == "box":
            return im0, im1
        shade = np.array([0.9, 1.0, 0.8], np.float32)
        return tuple(np.clip(im[..., None] * shade / 4, 0, 255)
                     .astype(np.uint8) for im in (im0, im1))
    tex = dense_texture((H, W + 48), 14)
    tex[8:30, 10:60] = 100.0
    tex[40:60, 50:130] = 200.0
    return tex[:, 24:24 + W], tex[:, 24 + 9:24 + 9 + W]


SGM_CASES = {
    "plane": ("plane", 0, 31, 1),
    "box": ("box", 0, 31, 1),
    "colour": ("colour", 0, 31, 1),
    "flat": ("flat", 0, 31, 1),
    "dmin": ("box", 4, 35, 1),
    "lr3": ("box", 0, 31, 3),
}


def sgm_references(names):
    """The JAX package's census, cost volume, aggregation and disparity on
    the SGM cases `names`: name -> dict of numpy arrays (census and cost
    on the grey images; aggregation at P1 6, P2 96)."""
    import jax.numpy as jnp
    import mrcal_tpu.stereo_sgm as js
    out = {}
    for name in names:
        kind, dmin, dmax, thr = SGM_CASES[name]
        im0, im1 = sgm_pair(kind)
        r = dict(disparity=np.asarray(js.stereo_matching_sgm(
            im0, im1, disparity_min=dmin, disparity_max=dmax,
            lr_consistency_threshold=thr)))
        if im0.ndim == 2 and thr == 1:
            c0 = js.census_transform(im0)
            c1 = js.census_transform(im1)
            cost = js.census_cost_volume(c0, c1, dmin, dmax)
            r.update(census0=np.asarray(c0), census1=np.asarray(c1),
                     cost=np.asarray(cost),
                     agg=np.asarray(js._sgm_aggregate(
                         cost, jnp.float32(6.0), jnp.float32(96.0), dmin,
                         dmax)))
        out[name] = r
    return out


# ----------------------------------------------------------------------------
# tests/test_torch_tools_*.py
# ----------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_tool(pkg, name, argv, stdin=""):
    """A tool run in this process with its standard streams captured: the
    JAX package's script tools/mrcal-<name> (pkg "jax", by runpy with
    sys.argv set) or the port's mrcal_tpu_torch.tools.<name>.main(argv,
    device="cpu") (pkg "torch", imported only then).  Returns (exit code,
    stdout, stderr, main's result (None for the JAX scripts)).  A
    SystemExit with a message exits 1 with the message on stderr, as the
    interpreter does."""
    import contextlib
    import importlib
    import io
    import runpy
    out, err = io.StringIO(), io.StringIO()
    saved = sys.argv, sys.stdin
    code, result = 0, None
    try:
        sys.stdin = io.StringIO(stdin)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            if pkg == "jax":
                path = os.path.join(ROOT, "tools", f"mrcal-{name}")
                sys.argv = [path] + list(argv)
                runpy.run_path(path, run_name="__main__")
            else:
                module = importlib.import_module(
                    f"mrcal_tpu_torch.tools.{name.replace('-', '_')}")
                result = module.main(list(argv), device="cpu")
    except SystemExit as e:
        if e.code is None or isinstance(e.code, int):
            code = e.code or 0
        else:
            code = 1
            err.write(f"{e.code}\n")
    finally:
        sys.argv, sys.stdin = saved
    return code, out.getvalue(), err.getvalue(), result


def jit_jax_unproject():
    """In a process that runs the JAX package's scripts: the package's
    top-level unproject (the name its scripts call) compiled once per lens
    model, normalization and shape.  Eagerly, each call of it costs ~0.3 s
    on the CPU, and mrcal-triangulate's sensitivity sweeps make some 950
    of them: minutes, until XLA's compiler runs out of memory.  Compiled,
    the results move by roundoff only."""
    import functools
    import jax
    import mrcal_tpu
    eager = mrcal_tpu.unproject

    @functools.lru_cache(maxsize=None)
    def compiled(lensmodel, normalize):
        return jax.jit(lambda q, i: eager(q, lensmodel, i,
                                          normalize=normalize))

    @functools.wraps(eager)
    def unproject(q, lensmodel, intrinsics_data, *, normalize=False,
                  get_gradients=False, out=None):
        if get_gradients or out is not None:
            return eager(q, lensmodel, intrinsics_data, normalize=normalize,
                         get_gradients=get_gradients, out=out)
        return compiled(lensmodel, bool(normalize))(
            np.asarray(q, np.float64), np.asarray(intrinsics_data,
                                                  np.float64))
    mrcal_tpu.unproject = unproject


def run_jax_tools(runs):
    """The JAX package's scripts on runs [(name, argv, stdin)], one after
    the other in this process: [(exit code, stdout, stderr)]."""
    jit_jax_unproject()
    return [run_tool("jax", name, argv, stdin)[:3]
            for name, argv, stdin in runs]


# ----------------------------------------------------------------------------
# tests/test_torch_visualization.py, tests/test_torch_tools_show.py and the
# drawing options of the tools
# ----------------------------------------------------------------------------

def _plain(x):
    """An artist's number or array as a float64 array (None and masked
    entries NaN)."""
    if x is None:
        return np.array(np.nan)
    if isinstance(x, np.ma.MaskedArray):
        x = np.ma.filled(x.astype(np.float64), np.nan)
    return np.array(x, dtype=np.float64)


def figure_contents(fig):
    """What a matplotlib figure shows, as strings and float64 arrays: for
    each axes its title, axis labels and limits, images (array, extent,
    clim), lines (data, label, color, marker, style), collections
    (offsets, color arrays and clim, a quiver's U and V, a contour set's
    levels), patches (a histogram's bars: x, width, height), texts (text
    and position) and legend entries; and the figure's suptitle.  A
    colorbar is an axes of its own, its limits the colorbar's."""
    from matplotlib.colors import to_rgba
    from matplotlib.contour import ContourSet
    from matplotlib.quiver import Quiver
    out = dict(suptitle=fig._suptitle.get_text() if fig._suptitle else "",
               axes=[])
    for ax in fig.axes:
        a = dict(label=ax.get_label(), title=ax.get_title(),
                 xlabel=ax.get_xlabel(), ylabel=ax.get_ylabel(),
                 xlim=_plain(ax.get_xlim()), ylim=_plain(ax.get_ylim()))
        if hasattr(ax, "get_zlim"):
            a.update(zlabel=ax.get_zlabel(), zlim=_plain(ax.get_zlim()))
        a["images"] = [dict(array=_plain(im.get_array()),
                            extent=_plain(im.get_extent()),
                            clim=_plain([_plain(c) for c in im.get_clim()]))
                       for im in ax.images]
        a["lines"] = [dict(
            data=_plain(line.get_data_3d() if hasattr(line, "get_data_3d")
                        else line.get_xydata()),
            label=line.get_label(), color=_plain(to_rgba(line.get_color())),
            marker=str(line.get_marker()), linestyle=line.get_linestyle())
            for line in ax.lines]
        collections = []
        for c in ax.collections:
            d = dict(kind=type(c).__name__, offsets=_plain(c.get_offsets()),
                     array=_plain(c.get_array()),
                     clim=_plain([_plain(v) for v in c.get_clim()]))
            if isinstance(c, Quiver):
                d.update(U=_plain(c.U), V=_plain(c.V))
            if isinstance(c, ContourSet):
                d.update(levels=_plain(c.levels))
            collections.append(d)
        a["collections"] = collections
        a["patches"] = dict(
            x=_plain([p.get_x() for p in ax.patches]),
            width=_plain([p.get_width() for p in ax.patches]),
            height=_plain([p.get_height() for p in ax.patches]))
        a["texts"] = [dict(text=t.get_text(), position=_plain(
            t.get_position_3d() if hasattr(t, "get_position_3d")
            else t.get_position())) for t in ax.texts]
        legend = ax.get_legend()
        a["legend"] = ([t.get_text() for t in legend.get_texts()]
                       if legend is not None else [])
        out["axes"].append(a)
    return out


def close_figures():
    import matplotlib.pyplot as plt
    plt.close("all")


def viz_solved_scene():
    """tests/test_visualization.py's scene: make_scene(Ncameras=2,
    Nframes=8) with 0.2 px of noise, solved by the JAX package (outlier
    rejection on), and then three corners marked as outliers for the plots
    to show.  Returns (the solved optimization_inputs, numpy; the
    residuals x there)."""
    import mrcal_tpu as mrcal
    from test_calibration import make_scene, optimization_inputs_from_scene
    scene = make_scene(Ncameras=2, Nframes=8)
    oi = {k: v for k, v in
          optimization_inputs_from_scene(scene, perturb=False).items()
          if v is not None}
    np.random.seed(2)
    oi["observations_board"][..., :2] += \
        np.random.randn(*oi["observations_board"][..., :2].shape) * 0.2
    mrcal.optimize(**oi)
    oi = {k: (v if isinstance(v, (str, bool, int, float)) else np.array(v))
          for k, v in oi.items()}
    for i, y, x in ((3, 2, 4), (3, 5, 7), (10, 0, 0)):
        oi["observations_board"][i, y, x, 2] = -1.0
    _, x, _ = mrcal.optimizer_callback(no_jacobian=True, **oi)
    return oi, np.array(x)


VIZ_SPLINED = "LENSMODEL_SPLINED_STEREOGRAPHIC_order=3_Nx=9_Ny=7_fov_x_deg=120"
VIZ_REGION = np.array([[10, 10], [700, 10], [700, 500], [10, 500], [10, 10]],
                      dtype=float)


def viz_objects(mrcal, oi, x, directory):
    """The inputs of the cases, built by `mrcal` (either package) from the
    solved scene: its two cameras m0 and m1, copies of them with a
    valid-intrinsics region (m0r, m1r), a 9 x 7-knot splined model of 800
    x 600 (test_visualization.py's), the residuals x, the board image
    <directory>/board.png, and camera 0's valid region drawn into a gray
    and a BGR image."""
    m0 = mrcal.cameramodel(optimization_inputs=oi, icam_intrinsics=0)
    m1 = mrcal.cameramodel(optimization_inputs=oi, icam_intrinsics=1)
    m1.extrinsics_rt_fromref(oi["extrinsics_rt_fromref"][0])
    regions = []
    for m in (m0, m1):
        r = mrcal.cameramodel(m)
        r.valid_intrinsics_region(VIZ_REGION)
        regions.append(r)
    rng = np.random.default_rng(0)
    intr = np.concatenate([[420., 419., 399.5, 299.5],
                           rng.normal(size=2 * 9 * 7) * 2e-3])
    splined = mrcal.cameramodel(intrinsics=(VIZ_SPLINED, intr),
                                imagersize=(800, 600))
    return dict(m0=m0, m1=m1, m0r=regions[0], m1r=regions[1], oi=oi, x=x,
                splined=splined, image=os.path.join(directory, "board.png"),
                gray=np.full((600, 800), 128, np.uint8),
                bgr=np.zeros((600, 800, 3), np.uint8),
                paths=[os.path.join(directory, "board.png")]
                * len(oi["observations_board"]))


_RT_PLOT_REF = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0],
                         [0.0, 0.0, 1.0], [0.1, -0.2, 0.3]])
_RT10 = np.array([[1.0, 0.002, -0.001], [-0.002, 1.0, 0.003],
                  [0.001, -0.003, 1.0], [0.0, 0.0, 0.0]])
_POINTS = np.array([[0.1, 0.2, 1.5], [-0.3, 0.1, 2.0], [0.0, -0.2, 1.2]])

# name -> (function of the package's top level, arguments, keywords);
# "@name" is viz_objects' object of that name.  The grids are small, and
# most share one shape, 12 x 9 (the JAX package compiles each new
# shape).
VIZ_CASES = {
    "geometry": ("show_geometry", (["@m0", "@m1"],), {}),
    "geometry_thiscamera": ("show_geometry", (["@m1", "@m0"],), dict(
        show_calobjects="thiscamera", extratitle="opts", point_labels={},
        cameras_Rt_plot_ref=_RT_PLOT_REF, cameranames=["left", "right"])),
    "geometry_fromsolve": ("show_geometry", (["@m1"],),
                           dict(icam_extrinsics_fromsolve="all")),
    "geometry_given": ("show_geometry", (), dict(
        models_or_extrinsics_rt_fromref=[np.zeros(6),
                                         np.array([0.01, -0.02, 0.005,
                                                   -0.22, 0.02, 0.01])],
        rt_ref_frame="@frames", object_width_n=8, object_height_n=6,
        object_spacing=0.077, points=_POINTS, point_labels={0: "p0", 2: 7},
        axis_scale=0.05, title="given", xlabel="X", zlabel="Z")),
    "diff": ("show_projection_diff", (("@m0r", "@m1r"),), dict(
        gridn_width=12, observations=True, contours=True,
        valid_intrinsics_region=True)),
    "diff_vectorfield": ("show_projection_diff", (("@m0", "@m1"),), dict(
        gridn_width=12, vectorfield=True, vectorscale=5.0,
        extratitle="vf")),
    "diff_directions": ("show_projection_diff", (("@m0", "@m1"),), dict(
        gridn_width=12, directions=True, implied_Rt10=_RT10)),
    "diff_contour_increment": ("show_projection_diff", (("@m0", "@m1"),),
                               dict(gridn_width=12, contour_increment=0.5,
                                    contour_labels_font=",9", cbmax=2,
                                    title="diff", extratitle="contours")),
    "diff_three": ("show_projection_diff", (("@m0", "@m1", "@m0r"),),
                   dict(gridn_width=12, intrinsics_only=False)),
    "diff_intrinsics_only": ("show_projection_diff", (("@m0", "@m1"),),
                             dict(gridn_width=12, gridn_height=9,
                                  intrinsics_only=True, cbmax=50)),
    "diff_1m": ("show_projection_diff", (("@m0", "@m1"),),
                dict(gridn_width=12, distance=1.0)),
    "uncertainty": ("show_projection_uncertainty", ("@m0",), dict(
        gridn_width=12, distance=2.0, observed_pixel_uncertainty=0.2)),
    "uncertainty_overlays": ("show_projection_uncertainty", ("@m0r",), dict(
        gridn_width=12, isotropic=True, observations=True,
        valid_intrinsics_region=True, contours=True, cbmax=1,
        extratitle="overlays")),
    "uncertainty_vs_distance": ("show_projection_uncertainty_vs_distance",
                                ("@m0",), dict(distance_min=0.5,
                                               distance_max=10,
                                               Ndistances=6)),
    "uncertainty_vs_distance_iso": (
        "show_projection_uncertainty_vs_distance", ("@m1",),
        dict(where=(400.0, 300.0), isotropic=True, Ndistances=6,
             observed_pixel_uncertainty=0.2)),
    "uncertainty_vs_distance_center": (
        "show_projection_uncertainty_vs_distance", ("@m0",),
        dict(where="center", Ndistances=6, title="center")),
    "distortion": ("show_distortion_off_pinhole", ("@m0",),
                   dict(gridn_width=12)),
    "distortion_vectorfield": ("show_distortion_off_pinhole", ("@m1",),
                               dict(gridn_width=12, vectorfield=True,
                                    vectorscale=3, extratitle="vs")),
    "radial": ("show_distortion_off_pinhole_radial", ("@m0",), {}),
    "radial_fisheye": ("show_distortion_off_pinhole_radial", ("@m1",),
                       dict(show_fisheye_projections=True)),
    "valid_region": ("show_valid_intrinsics_region", ("@m0r",), {}),
    "valid_regions": ("show_valid_intrinsics_region", (["@m0r", "@m1"],),
                      dict(image="@image", points=_POINTS[:, :2] * 300,
                           cameranames=["a", "b"], extratitle="two")),
    "splined": ("show_splined_model_correction", ("@splined",),
                dict(gridn_width=12)),
    "splined_x_u": ("show_splined_model_correction", ("@splined",),
                    dict(gridn_width=12, xy="x", imager_domain=False,
                         extratitle="x surface in u")),
    "splined_vectorfield": ("show_splined_model_correction", ("@splined",),
                            dict(gridn_width=12, vectorfield=True,
                                 vectorscale=10, xy="y")),
    "board_observation": ("show_residuals_board_observation", ("@oi", 3),
                          {}),
    "board_observation_worst": ("show_residuals_board_observation",
                                ("@oi", 0), dict(from_worst=True, cbmax=2.0,
                                                 paths="@paths")),
    "board_observation_sorted": ("show_residuals_board_observation",
                                 ("@oi", 1),
                                 dict(i_observations_sorted_from_worst=[
                                     5, 2], x="@x", circlescale=2.0)),
    "histogram": ("show_residuals_histogram", ("@oi", 0), {}),
    "histogram_model": ("show_residuals_histogram", ("@m1r",),
                        dict(binwidth=0.05, extratitle="model-first")),
    "vectorfield": ("show_residuals_vectorfield", ("@oi",), {}),
    "vectorfield_model": ("show_residuals_vectorfield", ("@m0r",),
                          dict(x="@x", cbmax=2, extratitle="model-first")),
    "magnitudes": ("show_residuals_magnitudes", ("@oi",),
                   dict(icam_intrinsics=1)),
    "magnitudes_model": ("show_residuals_magnitudes", ("@m0r",),
                         dict(residuals="@x", cbmax=1.0)),
    "directions": ("show_residuals_directions", ("@m1r",),
                   dict(valid_intrinsics_region=False)),
    "regional": ("show_residuals_regional", ("@oi",), dict(gridn_width=8)),
    "regional_model": ("show_residuals_regional", ("@m0r",),
                       dict(gridn_width=6, gridn_height=5)),
    "stereo_pair_diff": ("show_stereo_pair_diff",
                         ((("@m0", "@m1"), ("@m0", "@m1r")),),
                         dict(gridn_width=12)),
    "stereo_pair_diff_vectorfield": (
        "show_stereo_pair_diff", ((("@m0", "@m1"), ("@m1", "@m0")),),
        dict(gridn_width=12, vectorfield=True, distance=3.0,
             observations=True, valid_intrinsics_region=True,
             extratitle="vf")),
}


def viz_resolve(arg, objects):
    """A case's argument with its "@name" placeholders replaced."""
    if isinstance(arg, str) and arg.startswith("@"):
        if arg == "@frames":
            return objects["oi"]["frames_rt_toref"]
        return objects[arg[1:]]
    if isinstance(arg, (list, tuple)):
        return type(arg)(viz_resolve(a, objects) for a in arg)
    if isinstance(arg, dict):
        return {k: viz_resolve(v, objects) for k, v in arg.items()}
    return arg


def viz_call(mrcal, case, objects, **extra):
    """One case by `mrcal`'s function (extra: device="cpu" for the port):
    (figure_contents of its figure, the array it returns beside the figure
    or None).  The figure is closed."""
    fn, args, kw = case
    out = getattr(mrcal, fn)(*viz_resolve(args, objects),
                             **viz_resolve(kw, objects), **extra)
    fig, array = out if isinstance(out, tuple) else (out, None)
    try:
        return figure_contents(fig), (None if array is None
                                      else np.array(array, np.float64))
    finally:
        close_figures()


def viz_references(oi, x, directory, names):
    """The JAX package's cases `names`: {name: viz_call's result}; and
    under "board_residuals" visualization._board_residuals of the scene,
    every camera."""
    import mrcal_tpu as mrcal
    import mrcal_tpu.visualization
    share_jax_evaluations()
    objects = viz_objects(mrcal, oi, x, directory)
    out = {name: viz_call(mrcal, VIZ_CASES[name], objects)
           for name in names}
    if "histogram" in names:
        out["board_residuals"] = tuple(
            np.array(a) for a in mrcal_tpu.visualization._board_residuals(oi))
    return out


def viz_explore_references(oi, directory, calls):
    """The JAX package's show_* on the models of a solve, as the JAX
    mrcal-calibrate-cameras --explore shell calls them: calls [(name in
    the shell, function, target, arguments, keywords)], target "models"
    (the function of every model), "camera <i>" (of model i, with the
    shell's title) or "oi" (of the optimization_inputs); "{directory}" in
    a keyword is `directory`, and a shell name ending in _worst adds
    from_worst=True.  Returns [figure_contents] in order."""
    import mrcal_tpu as mrcal
    share_jax_evaluations()
    models = [mrcal.cameramodel(optimization_inputs=oi, icam_intrinsics=i)
              for i in range(len(oi["intrinsics"]))]
    for i, m in enumerate(models[1:]):
        m.extrinsics_rt_fromref(oi["extrinsics_rt_fromref"][i])
    out = []
    for shell_name, name, target, args, kw in calls:
        fn = getattr(mrcal, name)
        kw = {k: v.format(directory=directory) if isinstance(v, str) else v
              for k, v in kw.items()}
        if shell_name.endswith("_worst"):
            kw["from_worst"] = True
        if target == "models":
            fig = fn(models, *args, **kw)
        elif target == "oi":
            fig = fn(oi, *args, **kw)
        else:
            i = int(target.split()[1])
            fig = fn(models[i], *args, title=f"{name} camera {i}", **kw)
        out.append(figure_contents(fig[0] if isinstance(fig, tuple)
                                   else fig))
        close_figures()
    return out


def run_jax_show_tools(runs):
    """The JAX package's scripts on runs [(name, argv, stdin)], as
    run_jax_tools, with figure_contents of each figure a script saves
    (matplotlib's Figure.savefig wrapped): [(exit code, stdout, stderr,
    [figure_contents])]."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.figure
    saved = []
    savefig = matplotlib.figure.Figure.savefig

    def recording_savefig(self, *args, **kw):
        saved.append(figure_contents(self))
        return savefig(self, *args, **kw)
    matplotlib.figure.Figure.savefig = recording_savefig
    jit_jax_unproject()
    share_jax_evaluations()
    out = []
    for name, argv, stdin in runs:
        del saved[:]
        out.append(tuple(run_tool("jax", name, argv, stdin)[:3])
                   + (list(saved),))
        close_figures()
    return out


# ----------------------------------------------------------------------------
# tests/test_torch_sfm_points.py
# ----------------------------------------------------------------------------

def sfm_points_scene(name):
    """The optimization_inputs of tests/test_sfm_points.py's two solves,
    built as its tests build them: "noiseless" (test_sfm_points_recovery:
    exact observations, the fixed points anchoring the gauge) and "noisy"
    (test_sfm_points_noisy: 0.2 px), and "noisy_core", the noisy scene
    with the intrinsics core optimized."""
    from test_sfm_points import make_sfm_scene
    noisy = name.startswith("noisy")
    scene = make_sfm_scene(sigma=0.2, seed=2) if noisy else \
        make_sfm_scene(sigma=0.0)
    np.random.seed(3 if noisy else 1)
    pts = scene["points_true"].copy()
    Nfix = scene["Npoints_fixed"]
    pts[:len(pts) - Nfix] += np.random.randn(len(pts) - Nfix, 3) * \
        (0.03 if noisy else 0.05)
    ext = scene["extrinsics_true"] + \
        np.random.randn(*scene["extrinsics_true"].shape) * \
        (0.005 if noisy else 0.01)
    oi = dict(
        intrinsics=scene["intrinsics"].copy(),
        extrinsics_rt_fromref=ext,
        points=pts,
        observations_point=scene["observations_point"].copy(),
        indices_point_camintrinsics_camextrinsics=scene["indices_point"],
        lensmodel=scene["lensmodel"],
        imagersizes=scene["imagersizes"],
        Npoints_fixed=Nfix,
        do_optimize_intrinsics_core=False,
        do_optimize_intrinsics_distortions=False,
        do_apply_outlier_rejection=False)
    if name == "noisy_core":
        oi["do_optimize_intrinsics_core"] = True
    if not noisy:
        oi.update(frames_rt_toref=None, observations_board=None,
                  indices_frame_camintrinsics_camextrinsics=None,
                  calobject_warp=None, do_optimize_extrinsics=True,
                  do_optimize_frames=True, do_apply_regularization=True)
    return oi


def sfm_points_reference(scene, callback=False, solve=True):
    """The JAX package's f64 optimize() of a discrete-point problem: scene
    is a name of sfm_points_scene (built here) or optimization_inputs.
    Returns (the inputs, dict of the normal equations at the inputs' state
    ("ne") and of the solve: rms, b_packed, x, iterations, the solved
    points and extrinsics; with callback, optimizer_callback's b, x and J
    (CSR: shape, indptr, indices, data) at the inputs)."""
    import copy
    import jax
    import jax.numpy as jnp
    import mrcal_tpu
    from mrcal_tpu.optimize import solver
    from mrcal_tpu.optimize.layout import spec_from_inputs
    from mrcal_tpu.optimize.residuals import (arrays_from_inputs,
                                              pack_params, params_from_arrays)
    oi = sfm_points_scene(scene) if isinstance(scene, str) else scene
    spec = spec_from_inputs(**oi)
    arrays = arrays_from_inputs(**oi)
    b0 = pack_params(params_from_arrays(arrays), spec)
    ne = jax.jit(solver.build_normal_equations(
        spec, arrays, dict(board=np.asarray(arrays["indices_board"]),
                           point=np.asarray(arrays["indices_point"]))))(
        jnp.asarray(b0), arrays)
    out = dict(ne={k: np.asarray(v) for k, v in ne.items()})
    if not solve:
        return oi, out
    if callback:
        b, x, J = mrcal_tpu.optimizer_callback(**copy.deepcopy(oi))
        J = J.tocsr()
        out["callback"] = dict(b=np.asarray(b), x=np.asarray(x),
                               shape=J.shape, indptr=J.indptr,
                               indices=J.indices, data=J.data)
    oi_j = copy.deepcopy(oi)
    stats = mrcal_tpu.optimize(precision="f64", **oi_j)
    out.update(rms=float(stats["rms_reproj_error__pixels"]),
               b_packed=np.asarray(stats["b_packed"]),
               x=np.asarray(stats["x"]), niterations=stats["niterations"],
               points=oi_j["points"],
               extrinsics_rt_fromref=oi_j["extrinsics_rt_fromref"])
    return oi, out
