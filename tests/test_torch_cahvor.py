"""The port's CAHVOR and CAHVORE models and the .cahvor format against the
JAX package, in float64 on the CPU:

  - project_core and unproject_core at 1e-12 relative, CAHVOR and CAHVORE
    at linearity -0.3, 0, 0.37 and 1, with points on the optical axis and
    within 1e-8 of it (theta <= 1e-8 passes through unchanged);
  - project's gradients (and unproject's on CAHVOR) at 1e-10 relative;
  - a small optimize() with each model (8 frames of a 6 x 5 board),
    rms at 1e-10 relative;
  - cahvor.write gives the JAX package's bytes, and write -> read round
    trips, for CAHVOR, CAHVORE and a pinhole model (a CAHV file), through
    cahvor.read, read_from_string, cameramodel's fallback reader and a
    file name ending in .cahvor; read_transforms.

Every JAX projection reference is jitted, once per model."""

import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mrcal_tpu
from mrcal_tpu import cahvor as jcahvor
from mrcal_tpu import lensmodels as jlm
from mrcal_tpu import projections as jproj
import mrcal_tpu_torch
from mrcal_tpu_torch import cahvor as tcahvor
from mrcal_tpu_torch import lensmodels as tlm
from mrcal_tpu_torch import problems as tproblems
from mrcal_tpu_torch import projections as tproj

from test_torch_residuals import torch_threads  # noqa: F401

CAHVORE = [f"LENSMODEL_CAHVORE_linearity={l}" for l in (-0.3, 0, 0.37, 1)]
MODELS = ["LENSMODEL_CAHVOR"] + CAHVORE


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _intrinsics(model, axis=(0.01, -0.02)):
    """A camera with a tilted distortion axis (alpha, beta) and small
    radial (and pupil) terms."""
    n = tlm.lensmodel_num_params(model)
    rng = np.random.default_rng(n)
    intr = np.concatenate([[800.0, 780.0, 399.5, 299.5], axis,
                           rng.normal(size=n - 6) * 0.02])
    return intr


def _points(intr):
    """Rays across the imager, and three on or within 1e-8 rad of the
    distortion axis."""
    rng = np.random.default_rng(3)
    v = np.concatenate([rng.uniform(-0.4, 0.4, (40, 2)),
                        np.ones((40, 1))], axis=-1)
    sa, sb = np.sin(intr[4]), np.sin(intr[5])
    o = np.array([sa * np.cos(intr[5]), sb, np.cos(intr[4]) * np.cos(intr[5])])
    v[0] = o
    v[1] = 2.0 * o + [3e-9, 0.0, 0.0]
    v[2] = 0.5 * o + [0.0, -2e-9, 0.0]
    return v


@pytest.mark.parametrize("model", MODELS)
def test_project_unproject_core_match_jax(model):
    """Values at 1e-12 relative; the three points on the axis take the
    theta <= 1e-8 branch of CAHVORE (and give the pinhole projection of
    the point)."""
    intr = _intrinsics(model)
    v = _points(intr)
    q_j = np.asarray(jax.jit(jlm.project_core, static_argnums=2)(
        v, intr, model))
    q_t = tlm.project_core(torch.as_tensor(v), torch.as_tensor(intr), model)
    assert _rel(q_t.numpy(), q_j) <= 1e-12
    v_j = np.asarray(jax.jit(jlm.unproject_core, static_argnums=2)(
        q_j, intr, model))
    v_t = tlm.unproject_core(torch.as_tensor(q_j), torch.as_tensor(intr),
                             model)
    assert _rel(v_t.numpy(), v_j) <= 1e-12
    if "CAHVORE" in model:
        pinhole = tlm.project_core(torch.as_tensor(v[:3]),
                                   torch.as_tensor(intr[:4]),
                                   "LENSMODEL_PINHOLE")
        assert _rel(q_t[:3].numpy(), pinhole.numpy()) <= 1e-15


@pytest.mark.parametrize("model", ["LENSMODEL_CAHVOR",
                                   "LENSMODEL_CAHVORE_linearity=0.37"])
def test_project_unproject_gradients_match_jax(model):
    """project's gradients at 1e-10 relative, and on CAHVOR unproject's
    (the JAX package differentiates its fixed-iteration solve; the port
    takes the implicit function theorem at the converged point, the same
    code for every iterative model)."""
    intr = _intrinsics(model)
    v = _points(intr)[3:13].reshape(2, 5, 3)
    q = np.asarray(jlm.project_core(v, intr, model))
    unproject = model == "LENSMODEL_CAHVOR"

    def f(v, q, intr):
        return (jproj.project(v, model, intr, get_gradients=True),
                jproj.unproject(q, model, intr, get_gradients=True)
                if unproject else ())
    ref_p, ref_u = jax.jit(f)(v, q, intr)
    pairs = [(tproj.project(v, model, intr, get_gradients=True,
                            device="cpu"), ref_p)]
    if unproject:
        pairs.append((tproj.unproject(q, model, intr, get_gradients=True,
                                      device="cpu"), ref_u))
    for got, ref in pairs:
        assert len(got) == len(ref) == 3
        for a, b in zip(got, ref):
            assert _rel(a.numpy(), b) <= 1e-10


@pytest.mark.parametrize("model", ["LENSMODEL_CAHVOR",
                                   "LENSMODEL_CAHVORE_linearity=0.37"])
def test_optimize_matches_jax(model):
    """A small board calibration with each model, perturbed from a seed:
    the port's rms at 1e-10 relative to the JAX package's f64 solve, in
    the same number of iterations.  (With 4 frames CAHVOR's r0, which
    scales the off-axis offsets as the focal lengths do, leaves a flat
    valley that both packages crawl along for 256 iterations; 8 frames
    resolve it.)"""
    oi = tproblems.perturbed_oi(tproblems.make_problem(
        Ncameras=1, Nframes=8, W=6, H=5, model=model, device="cpu")[0],
        seed=1)
    oi["do_apply_outlier_rejection"] = False
    kw = dict(update_threshold=1e-7, max_iterations=300)
    s_j = mrcal_tpu.optimize(precision="f64", **kw,
                             **{k: (v.copy() if isinstance(v, np.ndarray)
                                    else v) for k, v in oi.items()})
    s_t = mrcal_tpu_torch.optimize(device="cpu", **kw, **oi)
    rms_j = s_j["rms_reproj_error__pixels"]
    assert abs(s_t["rms_reproj_error__pixels"] - rms_j) <= 1e-10 * rms_j
    assert s_t["niterations"] == s_j["niterations"]


def _model(pkg, lensmodel):
    intr = (_intrinsics(lensmodel, axis=(0.03, -0.01))
            if lensmodel != "LENSMODEL_PINHOLE"
            else np.array([800.0, 780.0, 399.5, 299.5]))
    return pkg.cameramodel(intrinsics=(lensmodel, intr),
                           imagersize=(800, 600),
                           rt_cam_ref=np.array([0.01, -0.2, 0.05,
                                                1.0, -0.5, 2.0]))


@pytest.mark.parametrize("lensmodel", ["LENSMODEL_CAHVOR",
                                       "LENSMODEL_CAHVORE_linearity=0.37",
                                       "LENSMODEL_PINHOLE"])
def test_cahvor_write_read_match_jax(lensmodel, tmp_path):
    """The written file is the JAX package's, byte for byte; reading it
    back (cahvor.read, read_from_string, the cameramodel constructor's
    fallback, a .cahvor file name) gives the model and what the JAX
    package reads."""
    mt, mj = _model(mrcal_tpu_torch, lensmodel), _model(mrcal_tpu, lensmodel)
    ft, fj = io.StringIO(), io.StringIO()
    tcahvor.write(ft, mt, note="a note\non two lines")
    jcahvor.write(fj, mj, note="a note\non two lines")
    text = ft.getvalue()
    assert text == fj.getvalue()
    path = str(tmp_path / "m.cahvor")
    mt.write(path)
    buf = io.StringIO()
    mt.write(buf, cahvor=True)
    with open(path) as f:
        assert f.read() == buf.getvalue() == _written(mj)
    want = jcahvor.read_from_string(text)
    for back in (tcahvor.read_from_string(text), tcahvor.read(path),
                 tcahvor.read(io.StringIO(text)),
                 mrcal_tpu_torch.cameramodel(path)):
        assert back.intrinsics()[0] == want.intrinsics()[0] == \
            mt.intrinsics()[0]
        np.testing.assert_allclose(back.intrinsics()[1],
                                   want.intrinsics()[1], rtol=0, atol=1e-12)
        np.testing.assert_allclose(back.intrinsics()[1], mt.intrinsics()[1],
                                   rtol=0, atol=1e-8)
        np.testing.assert_allclose(back.extrinsics_rt_fromref(),
                                   mt.extrinsics_rt_fromref(), atol=1e-10)
        assert tuple(back.imagersize()) == (800, 600)


def _written(model):
    f = io.StringIO()
    jcahvor.write(f, model)
    return f.getvalue()


def test_read_transforms_matches_jax(tmp_path):
    text = ("# a JPL transforms file\n"
            "ins2veh = (0.1 0.2 -0.3) (0.9 0.1 -0.2 0.3)\n"
            "\n"
            "cam2ins[0] = (1 2 3) (1 0 0 0)\n"
            "cam2ins[3] = (-0.5 0.25 1e-3) (0.5 0.5 0.5 0.5)\n")
    path = tmp_path / "transforms.txt"
    path.write_text(text)
    want = jcahvor.read_transforms(str(path))
    for got in (mrcal_tpu_torch.read_transforms(str(path)),
                tcahvor.read_transforms(io.StringIO(text))):
        np.testing.assert_allclose(got["veh_from_ins"], want["veh_from_ins"],
                                   atol=1e-12)
        assert sorted(got["ins_from_camera"]) == [0, 3]
        for i, Rt in want["ins_from_camera"].items():
            np.testing.assert_allclose(got["ins_from_camera"][i], Rt,
                                       atol=1e-12)
    with pytest.raises(Exception, match="duplicate"):
        tcahvor.read_transforms(io.StringIO(text + "cam2ins[0] = (1 2 3) "
                                            "(1 0 0 0)\n"))
