"""Import a ROS/OpenCV camera yaml into a .cameramodel.

The port of tools/mrcal-from-ros (reference: mrcal-from-ros): writes the
model on standard output; five or four nonzero distortion coefficients
give LENSMODEL_OPENCV5 or _OPENCV4, none LENSMODEL_PINHOLE.  Needs the
yaml package.

    python -m mrcal_tpu_torch.tools.from_ros camera.yaml > camera.cameramodel
"""

import argparse
import sys

import numpy as np

from .._config import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mrcal_tpu_torch.tools.from_ros",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("yamlfile")
    return p.parse_args(argv)


def main(argv=None, *, device=None):
    """The tool on `argv`.  The model is host data; `device` is checked as
    every tool checks it (the card unless "cpu").  Returns the model."""
    a = parse_args(argv)
    resolve_device(device)
    import yaml
    from ..cameramodel import cameramodel

    with open(a.yamlfile) as f:
        d = yaml.safe_load(f)

    K = np.array(d["camera_matrix"]["data"]).reshape(3, 3)
    dist = np.array(d.get("distortion_coefficients", {}).get("data", []))
    W = d["image_width"]
    H = d["image_height"]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    if dist.size >= 5 and np.any(dist):
        lm = "LENSMODEL_OPENCV5"
        intr = np.array([fx, fy, cx, cy, *dist[:5]])
    elif dist.size >= 4 and np.any(dist):
        lm = "LENSMODEL_OPENCV4"
        intr = np.array([fx, fy, cx, cy, *dist[:4]])
    else:
        lm = "LENSMODEL_PINHOLE"
        intr = np.array([fx, fy, cx, cy])
    m = cameramodel(intrinsics=(lm, intr), imagersize=(W, H))
    m.write(sys.stdout)
    return m


if __name__ == "__main__":
    main()
