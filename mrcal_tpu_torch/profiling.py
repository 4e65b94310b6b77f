"""Phase timers and device traces.

Counterpart of ``mrcal_tpu/profiling.py``.  Two mechanisms:

1. `phase(name)`: a nestable wall-clock timer on the host.  The solver
   wraps its stages in these; `optimize(**oi)` returns the per-phase
   breakdown in `stats["time_s"]`, and `timings()` and `counts()` expose
   the accumulated tree.  Every solve phase ends in a device->host read,
   so a phase's host time includes its device work.  Overhead is one
   perf_counter pair per phase, so it is always on.

2. `trace(logdir)`: a context manager around `torch.profiler.profile`
   (host and CUDA activities) that writes a Chrome trace (a .json file
   that chrome://tracing and Perfetto open) of everything inside into
   `logdir`.  With no logdir it reads MRCAL_TPU_PROFILE, as the JAX
   package does; `optimize()` and `optimize_batch()` run each solve
   inside it.
"""

import contextlib
import os
import threading
import time

# accumulated {qualified phase name: seconds}; qualified = "/".join(stack).
# The accumulators are process-global (guarded by _lock); the phase stack
# is thread-local so concurrent optimize() calls (or user phase() blocks on
# other threads) cannot interleave each other's "outer/inner" names.
_acc = {}
_counts = {}
_lock = threading.Lock()
_tls = threading.local()


def _stack():
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def reset():
    """Clear accumulated phase timings."""
    with _lock:
        _acc.clear()
        _counts.clear()


def timings():
    """Accumulated phase wall-times since the last reset().

    Returns {name: seconds} where nested phases are "outer/inner"."""
    return dict(_acc)


def counts():
    """Number of times each phase ran since the last reset()."""
    return dict(_counts)


@contextlib.contextmanager
def phase(name):
    """Time a named phase (nestable; nested names join with '/')."""
    stack = _stack()
    stack.append(name)
    key = "/".join(stack)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        stack.pop()
        with _lock:
            _acc[key] = _acc.get(key, 0.0) + dt
            _counts[key] = _counts.get(key, 0) + 1


@contextlib.contextmanager
def trace(logdir=None):
    """Write a torch.profiler trace (host and, where there is a card, CUDA
    activities) of the enclosed block into `logdir` as a Chrome trace.

    logdir=None reads MRCAL_TPU_PROFILE from the environment; when that
    is unset too, this is a no-op."""
    logdir = logdir or os.environ.get("MRCAL_TPU_PROFILE")
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(str(logdir), exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        str(logdir),
        f"mrcal_tpu_torch.{os.getpid()}.{time.time_ns()}.trace.json"))


class _SolveTimer:
    """Collects one solve's phase breakdown for the stats dict, on top of
    the global accumulators."""

    def __init__(self):
        self.t = {}

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        with phase(name):
            try:
                yield
            finally:
                self.t[name] = self.t.get(name, 0.0) + \
                    time.perf_counter() - t0
