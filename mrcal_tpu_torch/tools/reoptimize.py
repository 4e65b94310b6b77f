"""Re-run the optimization stored in a model's optimization_inputs.

The port of tools/mrcal-reoptimize (reference: analyses/mrcal-reoptimize):
reproduce or diagnose a solve, or re-solve after tweaking the inputs.  The
solve runs on the CUDA card (device="cpu" from Python runs it on the
CPU).

    python -m mrcal_tpu_torch.tools.reoptimize --outfile out.cameramodel \\
        camera-0.cameramodel
"""

import argparse
import sys

import numpy as np

from .._config import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mrcal_tpu_torch.tools.reoptimize",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--skip-outlier-rejection", action="store_true")
    p.add_argument("--revive-outliers", action="store_true")
    p.add_argument("--outfile", default="-")
    p.add_argument("model")
    return p.parse_args(argv)


def main(argv=None, *, device=None):
    """The tool on `argv`, on `device` (the card unless "cpu").  Returns
    dict(stats, model) of the re-solve."""
    a = parse_args(argv)
    device = resolve_device(device)
    import mrcal_tpu_torch as mrcal

    m = mrcal.cameramodel(a.model)
    oi = m.optimization_inputs()
    if oi is None:
        raise SystemExit("model has no optimization_inputs")
    if a.revive_outliers:
        obs = np.asarray(oi["observations_board"])
        obs[..., 2] = np.abs(obs[..., 2])
    if a.skip_outlier_rejection:
        oi["do_apply_outlier_rejection"] = False
    stats = mrcal.optimize(device=device, **oi)
    print(f"## rms: {stats['rms_reproj_error__pixels']:.4f} px; "
          f"outliers: {stats['Noutliers']}", file=sys.stderr)
    m_out = mrcal.cameramodel(optimization_inputs=oi,
                              icam_intrinsics=m.icam_intrinsics() or 0)
    if a.outfile == "-":
        m_out.write(sys.stdout)
    else:
        m_out.write(a.outfile)
    return dict(stats=stats, model=m_out)


if __name__ == "__main__":
    main()
