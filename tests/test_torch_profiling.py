"""The port's profiling module: tests/test_profiling.py's cases on the
port (the nesting and accumulation of phases, optimize()'s phase
breakdown in its stats and in timings(), trace() a no-op without a
logdir, and a trace written with one), plus optimize_batch()'s phases and
the phase names of each precision, which are the JAX solver's
(mrcal_tpu/optimize/solver.py's _timer.phase calls)."""

import json

import pytest

import mrcal_tpu_torch as mrcal
from mrcal_tpu_torch import problems, profiling

from test_torch_residuals import torch_threads  # noqa: F401


def _oi():
    return problems.make_problem(Ncameras=1, Nframes=6, W=5, H=4,
                                 model="LENSMODEL_OPENCV4", device="cpu",
                                 do_apply_outlier_rejection=False)[0]


def test_phase_nesting_and_accumulation():
    profiling.reset()
    with profiling.phase("outer"):
        with profiling.phase("inner"):
            pass
        with profiling.phase("inner"):
            pass
    t = profiling.timings()
    assert set(t) == {"outer", "outer/inner"}
    assert profiling.counts()["outer/inner"] == 2
    assert profiling.counts()["outer"] == 1
    assert t["outer"] >= t["outer/inner"] >= 0.0
    profiling.reset()
    assert profiling.timings() == {} and profiling.counts() == {}


# the phases of one solve without outlier rejection, as the JAX solver
# names them
PHASES = {"f64": {"pack", "solve_f64", "fetch"},
          "mixed": {"pack", "solve_f32", "solve_polish_f64", "fetch"},
          "f32": {"pack", "solve_f32", "fetch"}}


@pytest.mark.parametrize("precision", sorted(PHASES))
def test_optimize_reports_phase_breakdown(precision):
    profiling.reset()
    stats = mrcal.optimize(device="cpu", precision=precision, **_oi())
    t = stats["time_s"]
    assert set(t) == PHASES[precision]
    assert all(v >= 0 for v in t.values())
    # the global accumulators saw the same phases, once each
    assert set(profiling.timings()) == PHASES[precision]
    assert set(profiling.counts().values()) == {1}


def test_optimize_batch_feeds_the_accumulators():
    profiling.reset()
    stats = mrcal.optimize_batch([_oi(), _oi()], device="cpu")
    assert set(stats[0]["time_s"]) == PHASES["f64"]
    assert set(profiling.timings()) == PHASES["f64"]


def test_outlier_rejection_phase():
    oi = _oi()
    oi["do_apply_outlier_rejection"] = True
    profiling.reset()
    stats = mrcal.optimize(device="cpu", **oi)
    assert set(stats["time_s"]) == PHASES["f64"] | {"outlier_rejection"}
    assert profiling.counts()["outlier_rejection"] >= 1


def test_trace_noop_without_logdir(monkeypatch, tmp_path):
    monkeypatch.delenv("MRCAL_TPU_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.trace():
        x = 1 + 1
    assert x == 2
    assert list(tmp_path.iterdir()) == []


def test_trace_writes_device_profile(tmp_path, monkeypatch):
    """MRCAL_TPU_PROFILE dumps a torch.profiler trace during optimize():
    one Chrome trace per solve, holding the solve's ops."""
    logdir = tmp_path / "prof"
    monkeypatch.setenv("MRCAL_TPU_PROFILE", str(logdir))
    mrcal.optimize(device="cpu", **_oi())
    dumped = [p for p in logdir.rglob("*") if p.is_file()]
    assert len(dumped) == 1 and dumped[0].name.endswith(".trace.json")
    events = json.loads(dumped[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_trace_with_logdir(tmp_path, monkeypatch):
    monkeypatch.delenv("MRCAL_TPU_PROFILE", raising=False)
    import torch
    with profiling.trace(tmp_path):
        torch.ones(3).sum()
    assert [p.name.endswith(".trace.json") for p in tmp_path.iterdir()] \
        == [True]
