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


