"""Time the port's normal equations and Schur step of two checkouts on the
card, in turns, on sfm_points' full-size start (398 frames, 14,996 variable
points, 398 (intrinsics, extrinsics) pairs).

    python3 tests/time_sfm_points_normal_equations.py OLD NEW NEW OLD

Each argument is the root of a checkout that holds ``mrcal_tpu_torch``.
This checkout builds the inputs (``problems.sfm_points()``), then each root
runs in a process of its own: two warm-up calls and ten timed ones of
``build_normal_equations``'s function and of ``schur_step`` at lambda 1e-4,
and the sums of a few of their outputs, so that the checkouts can be seen to
compute the same."""

import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def time_one(root, path):
    import torch
    sys.path.insert(0, root)
    import mrcal_tpu_torch
    assert mrcal_tpu_torch.__file__.startswith(root), mrcal_tpu_torch.__file__
    from mrcal_tpu_torch.convert import from_reference
    from mrcal_tpu_torch.optimize.solver import (build_normal_equations,
                                                 schur_step)
    oi = np.load(path, allow_pickle=True)["oi"].item()
    spec, arrays, b = from_reference(oi, device="cuda")
    f = build_normal_equations(spec, arrays, dict(
        board=np.zeros((0, 3), np.int64),
        point=oi["indices_point_camintrinsics_camextrinsics"]))
    lam = torch.full((), 1e-4, dtype=b.dtype, device=b.device)
    with torch.no_grad():
        ne = f(b, arrays)
        step = schur_step(ne, lam, spec)
        for label, fn in (("normal_equations", lambda: f(b, arrays)),
                          ("schur_step", lambda: schur_step(ne, lam, spec))):
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            print(f"[cmp] {root}: {label} "
                  f"{(time.perf_counter() - t0) / 10 * 1e3:.3f} ms per call",
                  flush=True)
    print(f"[cmp] {root}: E {float(ne['E'])!r}, sum Hcc "
          f"{float(ne['Hcc'].sum())!r}, sum |Cp| "
          f"{float(ne['Cp'].abs().sum())!r}, sum g_c "
          f"{float(ne['g_c'].sum())!r}, step |dc| "
          f"{float(step[0].abs().sum())!r} |dp| "
          f"{float(step[2].abs().sum())!r}", flush=True)


def main(roots):
    sys.path.insert(0, os.path.dirname(HERE))
    from mrcal_tpu_torch import problems
    oi, _ = problems.sfm_points(**problems.SFM_POINTS)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "oi.npz")
        np.savez(path, oi=np.array(oi, dtype=object))
        for root in roots:
            subprocess.run([sys.executable, __file__, "--one",
                            os.path.abspath(root), path], check=True,
                           timeout=600)


if __name__ == "__main__":
    if sys.argv[1] == "--one":
        time_one(*sys.argv[2:4])
    else:
        main(sys.argv[1:])
