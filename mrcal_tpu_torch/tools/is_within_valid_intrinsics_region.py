"""Annotate 'x y' points with whether they are inside the model's
valid-intrinsics region.

The port of tools/mrcal-is-within-valid-intrinsics-region: reads the
points on standard input and writes 'x y 0|1' rows on standard output.
Runs on the CUDA card (device="cpu" from Python runs it on the CPU).

    python -m mrcal_tpu_torch.tools.is_within_valid_intrinsics_region \\
        camera-0.cameramodel < points.vnl
"""

import argparse
import sys

from .._config import resolve_device
from ._common import host, read_points


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mrcal_tpu_torch.tools."
             "is_within_valid_intrinsics_region",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model")
    return p.parse_args(argv)


def main(argv=None, *, device=None):
    """The tool on `argv`, reading standard input, on `device` (the card
    unless "cpu").  Returns the (N,) mask, or None when the model has no
    region."""
    a = parse_args(argv)
    device = resolve_device(device)
    import mrcal_tpu_torch as mrcal
    m = mrcal.cameramodel(a.model)
    q = read_points(sys.stdin)
    mask = mrcal.is_within_valid_intrinsics_region(q, m, device=device)
    if mask is not None:
        mask = host(mask)
    print("# x y is-within-valid-intrinsics-region")
    for row, ok in zip(q, mask if mask is not None else [0] * len(q)):
        print(f"{row[0]} {row[1]} {int(bool(ok))}")
    return mask


if __name__ == "__main__":
    main()
