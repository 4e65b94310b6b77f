"""Reproject pixel points from one model to another.

The port of tools/mrcal-reproject-points: reads 'x y' pairs on standard
input, unprojects them through the first model, rotates them into the
second camera (unless --intrinsics-only) and projects them; writes the
reprojected pairs on standard output.  Runs on the CUDA card
(device="cpu" from Python runs it on the CPU).

    python -m mrcal_tpu_torch.tools.reproject_points from.cameramodel \\
        to.cameramodel < points.vnl
"""

import argparse
import sys

from .._config import resolve_device
from ._common import host, read_points


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mrcal_tpu_torch.tools.reproject_points",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--intrinsics-only", action="store_true")
    p.add_argument("model_from")
    p.add_argument("model_to")
    return p.parse_args(argv)


def reproject_points(q, m_from, m_to, *, intrinsics_only=False, device):
    """The pixels q (N, 2) of m_from as m_to sees them, (N, 2) numpy."""
    import mrcal_tpu_torch as mrcal
    v = mrcal.unproject(q, *m_from.intrinsics(), device=device)
    if not intrinsics_only:
        Rt = mrcal.compose_Rt(m_to.Rt_cam_ref(), m_from.Rt_ref_cam(),
                              device=device)
        v = mrcal.rotate_point_R(Rt[:3], v, device=device)
    return host(mrcal.project(v, *m_to.intrinsics(), device=device))


def main(argv=None, *, device=None):
    """The tool on `argv`, reading standard input, on `device` (the card
    unless "cpu").  Returns the reprojected (N, 2) pixels."""
    a = parse_args(argv)
    device = resolve_device(device)
    import mrcal_tpu_torch as mrcal
    m_from = mrcal.cameramodel(a.model_from)
    m_to = mrcal.cameramodel(a.model_to)
    qo = reproject_points(read_points(sys.stdin), m_from, m_to,
                          intrinsics_only=a.intrinsics_only, device=device)
    print("# x y")
    for row in qo:
        print(f"{row[0]:.6f} {row[1]:.6f}")
    return qo


if __name__ == "__main__":
    main()
