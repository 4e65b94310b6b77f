"""The port stands alone: importing mrcal_tpu_torch (the splined path,
the multi-device package and the uncertainty modules included, and
building the splined bench problem) loads neither jax nor mrcal_tpu, and
no module of the port (nor chip_smoke.py) imports either.  The public
entry points of the projection and uncertainty modules run on the card
unless told otherwise."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "mrcal_tpu")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "mrcal_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name):
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_import_loads_no_jax():
    # counts only what the import adds, should a site hook preload jax
    code = ("import sys; before = set(sys.modules); "
            "import mrcal_tpu_torch, mrcal_tpu_torch.problems, "
            "mrcal_tpu_torch.convert, mrcal_tpu_torch.ops, "
            "mrcal_tpu_torch.parallel, mrcal_tpu_torch.projections, "
            "mrcal_tpu_torch.factorization, mrcal_tpu_torch.cameramodel, "
            "mrcal_tpu_torch.model_analysis, mrcal_tpu_torch.utils; "
            "from mrcal_tpu_torch.lensmodels import splined_deltau; "
            "from mrcal_tpu_torch.optimize.solver import "
            "build_normal_equations_splined, lm_solve; "
            "from mrcal_tpu_torch.optimize.jacobian import "
            "optimizer_callback; "
            "mrcal_tpu_torch.problems.splined_30x18(); "
            "bad = sorted(m for m in set(sys.modules) - before "
            f"if m.split('.')[0] in {FORBIDDEN!r}); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_sources_import_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def _entry_point_calls():
    """name -> (function, arguments): each public entry point of the
    projection, pose, utils, factorization and uncertainty modules that
    this slice added, on a small input."""
    import mrcal_tpu_torch as m
    from mrcal_tpu_torch import problems
    oi = problems.make_problem(Ncameras=1, Nframes=3, W=4, H=3,
                               model="LENSMODEL_OPENCV4", device="cpu")[0]
    model = m.cameramodel(optimization_inputs=oi, icam_intrinsics=0)
    model.valid_intrinsics_region([[0., 0.], [799., 0.], [799., 599.]])
    intr = oi["intrinsics"][0]
    lens = oi["lensmodel"]
    v = np.array([[0.1, -0.2, 1.0], [0.3, 0.1, 2.0], [-0.2, 0.2, 1.5]])
    q = np.array([[100., 200.], [400., 300.], [700., 500.]])
    rt = np.array([0.1, -0.2, 0.3, 1.0, 2.0, 3.0])
    Rt = m.Rt_from_rt(rt, device="cpu").numpy()
    return {
        "project": (m.project, (v, lens, intr)),
        "unproject": (m.unproject, (q, lens, intr)),
        "project_pinhole": (m.project_pinhole, (v,)),
        "unproject_lonlat": (m.unproject_lonlat, (q[:, :2] * 1e-3,)),
        "identity_Rt": (m.identity_Rt, ()),
        "r_from_R": (m.r_from_R, (Rt[:3],)),
        "invert_rt": (m.invert_rt, (rt,)),
        "compose_Rt": (m.compose_Rt, (Rt, Rt)),
        "transform_point_Rt": (m.transform_point_Rt, (Rt, v)),
        "compose_rt_tinyrt0_gradientrt0": (m.compose_rt_tinyrt0_gradientrt0,
                                           (rt,)),
        "qt_from_Rt": (m.qt_from_Rt, (Rt,)),
        "R_aligned_to_vector": (m.R_aligned_to_vector, (v,)),
        "align_procrustes_points_Rt01": (m.align_procrustes_points_Rt01,
                                         (v, v[::-1])),
        "align_procrustes_vectors_R01": (m.align_procrustes_vectors_R01,
                                         (v, v[::-1])),
        "sample_imager": (m.sample_imager, (4, None, 800, 600)),
        "sample_imager_unproject": (m.sample_imager_unproject,
                                    (4, None, 800, 600, lens, intr)),
        "worst_direction_stdev": (m.worst_direction_stdev,
                                  (np.eye(2)[None] * [[[1.0]], [[2.0]]],)),
        "projection_uncertainty": (m.projection_uncertainty, (v, model)),
        "projection_diff": (m.projection_diff, ([model, model],)),
        "stereo_pair_diff": (m.stereo_pair_diff,
                             ([(model, model), (model, model)],)),
        "implied_Rt10__from_unprojections": (
            m.implied_Rt10__from_unprojections, (q, v, v)),
        "is_within_valid_intrinsics_region": (
            m.is_within_valid_intrinsics_region, (q, model)),
        "model_resolution__deg_pixel": (m.model_resolution__deg_pixel,
                                        (model, 4)),
        "CHOLMOD_factorization": (m.CHOLMOD_factorization,
                                  (np.eye(3) + 0.1,)),
        "drt_cross_reprojection__dbpacked": (
            lambda **kw: m.drt_cross_reprojection__dbpacked(**oi, **kw),
            ()),
    }


@pytest.fixture(scope="module")
def entry_point_calls():
    return _entry_point_calls()


ENTRY_POINTS = ["project", "unproject", "project_pinhole",
                "unproject_lonlat", "identity_Rt", "r_from_R", "invert_rt",
                "compose_Rt", "transform_point_Rt",
                "compose_rt_tinyrt0_gradientrt0", "qt_from_Rt",
                "R_aligned_to_vector", "align_procrustes_points_Rt01",
                "align_procrustes_vectors_R01", "sample_imager",
                "sample_imager_unproject", "worst_direction_stdev",
                "projection_uncertainty", "projection_diff",
                "stereo_pair_diff", "implied_Rt10__from_unprojections",
                "is_within_valid_intrinsics_region",
                "model_resolution__deg_pixel", "CHOLMOD_factorization",
                "drt_cross_reprojection__dbpacked"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_run_on_the_card_unless_told(entry_point_calls,
                                                  monkeypatch, name):
    """device="cpu" runs on the CPU (tensors there); no device means the
    CUDA card, and without one each entry point raises rather than fall
    back to the CPU."""
    fn, args = entry_point_calls[name]
    out = fn(*args, device="cpu")
    for t in (out if isinstance(out, tuple) else (out,)):
        if torch.is_tensor(t):
            assert t.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn(*args)
