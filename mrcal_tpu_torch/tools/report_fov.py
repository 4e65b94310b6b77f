"""Report the field of view of a camera model.

The port of tools/mrcal-report-fov: the angles between the unprojections
of the imager's edge midpoints, computed on the CUDA card
(device="cpu" from Python computes them on the CPU).

    python -m mrcal_tpu_torch.tools.report_fov camera-0.cameramodel
"""

import argparse

import numpy as np

from .._config import resolve_device
from ._common import host


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mrcal_tpu_torch.tools.report_fov",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model")
    return p.parse_args(argv)


def main(argv=None, *, device=None):
    """The tool on `argv`, on `device` (the card unless "cpu").  Returns
    (fov_x, fov_y) in degrees."""
    a = parse_args(argv)
    device = resolve_device(device)
    import mrcal_tpu_torch as mrcal
    m = mrcal.cameramodel(a.model)
    W, H = m.imagersize()
    lm, intr = m.intrinsics()
    q_edges = np.array([[0, (H - 1) / 2], [W - 1, (H - 1) / 2],
                        [(W - 1) / 2, 0], [(W - 1) / 2, H - 1]], dtype=float)
    v = host(mrcal.unproject(q_edges, lm, intr, normalize=True,
                             device=device))
    fov_x = np.degrees(np.arccos(np.clip(np.dot(v[0], v[1]), -1, 1)))
    fov_y = np.degrees(np.arccos(np.clip(np.dot(v[2], v[3]), -1, 1)))
    print(f"fov_x = {fov_x:.2f} deg")
    print(f"fov_y = {fov_y:.2f} deg")
    return fov_x, fov_y


if __name__ == "__main__":
    main()
