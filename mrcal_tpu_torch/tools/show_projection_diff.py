"""Projection difference between models.

The port of tools/mrcal-show-projection-diff: the difference between the
models' projections over the first one's imager, after the transform
that best aligns them (none with --intrinsics-only), as a heatmap or
--vectorfield; its mean and maximum are printed.  Computed on the CUDA
card (device="cpu" from Python computes it on the CPU); matplotlib draws.

    python -m mrcal_tpu_torch.tools.show_projection_diff \\
        --hardcopy diff.png camera-0.cameramodel camera-0-opencv4.cameramodel
"""

import argparse

import numpy as np

from .._config import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mrcal_tpu_torch.tools.show_projection_diff",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--hardcopy", type=str, default=None)
    p.add_argument("--distance", type=float, default=None)
    p.add_argument("--gridn", type=int, nargs=2, default=[60, None])
    p.add_argument("--vectorfield", action="store_true")
    p.add_argument("--intrinsics-only", action="store_true")
    p.add_argument("--cbmax", type=float, default=4)
    p.add_argument("models", nargs="+")
    return p.parse_args(argv)


def main(argv=None, *, device=None):
    """The tool on `argv`, on `device` (the card unless "cpu").  Returns
    (the figure, difflen)."""
    a = parse_args(argv)
    device = resolve_device(device)
    import mrcal_tpu_torch as mrcal
    models = [mrcal.cameramodel(f) for f in a.models]
    fig, difflen = mrcal.show_projection_diff(
        models, gridn_width=a.gridn[0], gridn_height=a.gridn[1],
        distance=a.distance, vectorfield=a.vectorfield, cbmax=a.cbmax,
        intrinsics_only=a.intrinsics_only,
        hardcopy=a.hardcopy, device=device)
    print(f"mean diff: {float(np.mean(difflen)):.3f} px; "
          f"max: {float(np.max(difflen)):.3f} px")
    return fig, difflen


if __name__ == "__main__":
    main()
