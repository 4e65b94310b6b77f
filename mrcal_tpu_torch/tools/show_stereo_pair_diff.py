"""Compare the rectified geometry implied by two pairs of models.

The port of tools/mrcal-show-stereo-pair-diff: each pair's rectified
system, then the projection difference between the two rectified camera-0
models at infinity over a 40-wide grid; its mean and maximum are printed,
and with --hardcopy matplotlib draws it.  Computed on the CUDA card
(device="cpu" from Python computes it on the CPU).

    python -m mrcal_tpu_torch.tools.show_stereo_pair_diff \\
        a-0.cameramodel a-1.cameramodel b-0.cameramodel b-1.cameramodel
"""

import argparse

import numpy as np

from .._config import resolve_device
from ._common import host


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mrcal_tpu_torch.tools.show_stereo_pair_diff",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--hardcopy", type=str, default=None)
    p.add_argument("--az-fov-deg", type=float, default=60)
    p.add_argument("--el-fov-deg", type=float, default=50)
    p.add_argument("models", nargs=4,
                   help="pair A: model0 model1; pair B: model0 model1")
    return p.parse_args(argv)


def rect0_diff(pairA, pairB, az_fov_deg, el_fov_deg, device):
    """The tool's computation: (difflen, diff, q0, Rt10) of the projection
    difference between the two pairs' rectified camera-0 models, numpy."""
    import mrcal_tpu_torch as mrcal
    rect = [mrcal.rectified_system(pair, az_fov_deg=az_fov_deg,
                                   el_fov_deg=el_fov_deg, device=device)
            for pair in (pairA, pairB)]
    return tuple(host(x) for x in mrcal.projection_diff(
        (rect[0][0], rect[1][0]), gridn_width=40, distance=None,
        device=device))


def main(argv=None, *, device=None):
    """The tool on `argv`, on `device` (the card unless "cpu").  Returns
    difflen (and draws it with --hardcopy)."""
    a = parse_args(argv)
    device = resolve_device(device)
    import mrcal_tpu_torch as mrcal
    pairA = [mrcal.cameramodel(f) for f in a.models[:2]]
    pairB = [mrcal.cameramodel(f) for f in a.models[2:]]
    difflen = rect0_diff(pairA, pairB, a.az_fov_deg, a.el_fov_deg,
                         device)[0]
    print(f"rect0 diff: mean {float(np.mean(difflen)):.4f} px, "
          f"max {float(np.max(difflen)):.4f} px")
    if a.hardcopy:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots()
        im = ax.imshow(difflen)
        fig.colorbar(im, ax=ax)
        fig.savefig(a.hardcopy, dpi=120)
    return difflen


if __name__ == "__main__":
    main()
