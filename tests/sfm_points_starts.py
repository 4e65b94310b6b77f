"""sfm_points' start and stopping point, on the CPU.

    python tests/sfm_points_starts.py      (~5 minutes)

1. The start's rms at 20,000 and 40,000 observations for two ways of
   perturbing the frames: perturbed_oi(seed=1)'s draws added to
   rt_cam_ref, and the same draws on each frame's pose rt_ref_cam (what
   ``problems.sfm_points`` does); and at 40,000 observations, where each
   solve stands after 33 iterations.
2. sfm_points_20k solved with the default stopping rules and with deeper
   ones: the iterations, the rms and the errors of the variable points and
   of the translations against the truth."""

import copy
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import chip_smoke  # noqa: E402
from mrcal_tpu_torch import optimize, optimizer_callback, problems  # noqa: E402

SOLVE_KW = dict(update_threshold=1e-7, max_iterations=2000)


def starts(n):
    """(the builder's inputs, the inputs with the draws on rt_cam_ref, the
    truth) at n observations."""
    oi, truth = problems.sfm_points(Nobservations_total=n, device="cpu")
    exact = dict(oi, points=truth["points"].copy(),
                 extrinsics_rt_fromref=truth["extrinsics_rt_fromref"].copy())
    added = problems.perturbed_oi(exact, seed=1)
    nfix = oi["Npoints_fixed"]
    added["points"][-nfix:] = truth["points"][-nfix:]
    return oi, added, truth


def rms(oi):
    x = optimizer_callback(no_jacobian=True, device="cpu", **oi)[1]
    return float(np.sqrt(np.mean(x * x)))


def main():
    torch.set_num_threads(4)
    for n in (20000, 40000):
        oi, added, _ = starts(n)
        print(f"{n} observations: start rms {rms(added):.6g} px with the "
              f"draws added to rt_cam_ref, {rms(oi):.6g} px on rt_ref_cam",
              flush=True)
    for label, oi in zip(("on rt_ref_cam", "added to rt_cam_ref"),
                         starts(40000)[:2]):
        oi = copy.deepcopy(oi)
        s = optimize(device="cpu", **dict(SOLVE_KW, max_iterations=33), **oi)
        print(f"40000 observations, draws {label}: after {s['niterations']} "
              f"iterations E = {float(np.sum(s['x'] ** 2)):.6g}, rms "
              f"{s['rms_reproj_error__pixels']:.6g} px", flush=True)
    oi, _, truth = starts(20000)
    for kw in (dict(), dict(ftol=1e-10),
               dict(ftol=0.0, update_threshold=1e-12, max_iterations=400)):
        o = copy.deepcopy(oi)
        s = optimize(device="cpu", **dict(SOLVE_KW, **kw), **o)
        print(f"sfm_points_20k {kw or 'default'}: {s['niterations']} "
              f"iterations, rms {s['rms_reproj_error__pixels']!r} px, "
              f"errors {chip_smoke.sfm_points_errors(o, truth)}", flush=True)


if __name__ == "__main__":
    main()
