"""Export models to a kalibr camchain yaml.

The port of tools/mrcal-to-kalibr (reference: mrcal-to-kalibr): writes
the camchain on standard output, each camera after the first with its
T_cn_cnm1 from the one before.  PINHOLE, OPENCV4 and OPENCV8 models
(OPENCV8 truncated to radtan, with a warning) can be expressed.

    python -m mrcal_tpu_torch.tools.to_kalibr camera-0.cameramodel \\
        camera-1.cameramodel > camchain.yaml
"""

import argparse
import sys

import numpy as np

from .._config import resolve_device
from ._common import host


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mrcal_tpu_torch.tools.to_kalibr",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("models", nargs="+")
    return p.parse_args(argv)


def yamlblock(i, m, m_prev, device):
    """The camchain's text of camera i, model m, after model m_prev."""
    from .. import poseutils
    lm, intr = m.intrinsics()
    W, H = m.imagersize()
    out = [f"cam{i}:"]
    if lm == "LENSMODEL_PINHOLE":
        model, dist_model, dist = "pinhole", "none", []
    elif lm == "LENSMODEL_OPENCV4":
        model, dist_model, dist = "pinhole", "radtan", list(intr[4:8])
    elif lm == "LENSMODEL_OPENCV8":
        model, dist_model, dist = "pinhole", "radtan", list(intr[4:8])
        print(f"# WARNING cam{i}: OPENCV8 truncated to radtan "
              "(k1 k2 p1 p2)", file=sys.stderr)
    else:
        raise SystemExit(f"Cannot express {lm} in kalibr format")
    out.append(f"  camera_model: {model}")
    out.append("  intrinsics: [" + ", ".join(f"{v:.12g}" for v in intr[:4])
               + "]")
    out.append(f"  distortion_model: {dist_model}")
    out.append("  distortion_coeffs: [" + ", ".join(f"{v:.12g}"
                                                    for v in dist) + "]")
    out.append(f"  resolution: [{W}, {H}]")
    if m_prev is not None:
        # T_cn_cnm1: this camera from the previous one
        Rt = host(poseutils.compose_Rt(m.Rt_cam_ref(), m_prev.Rt_ref_cam(),
                                       device=device))
        T = np.eye(4)
        T[:3, :3] = Rt[:3]
        T[:3, 3] = Rt[3]
        out.append("  T_cn_cnm1:")
        for r in T:
            out.append("  - [" + ", ".join(f"{v:.12g}" for v in r) + "]")
    return "\n".join(out)


def main(argv=None, *, device=None):
    """The tool on `argv`, the poses composed on `device` (the card unless
    "cpu")."""
    a = parse_args(argv)
    device = resolve_device(device)
    from ..cameramodel import cameramodel
    models = [cameramodel(f) for f in a.models]
    prev = None
    for i, m in enumerate(models):
        print(yamlblock(i, m, prev, device))
        prev = m


if __name__ == "__main__":
    main()
