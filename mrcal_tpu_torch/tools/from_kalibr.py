"""Import a kalibr camchain yaml into .cameramodel files.

The port of tools/mrcal-from-kalibr (reference: mrcal-from-kalibr): one
model per camera of the chain, <outdir>/<camera name>.cameramodel, each
camera's pose composed along the chain's T_cn_cnm1.  Needs the yaml
package.

    python -m mrcal_tpu_torch.tools.from_kalibr --outdir models \\
        camchain.yaml
"""

import argparse

import numpy as np

from .._config import resolve_device
from ._common import host


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mrcal_tpu_torch.tools.from_kalibr",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--outdir", default=".")
    p.add_argument("camchain")
    return p.parse_args(argv)


def main(argv=None, *, device=None):
    """The tool on `argv`, the poses composed on `device` (the card unless
    "cpu").  Returns {camera name: model}."""
    a = parse_args(argv)
    device = resolve_device(device)
    import yaml
    from .. import poseutils
    from ..cameramodel import cameramodel

    with open(a.camchain) as f:
        chain = yaml.safe_load(f)

    models = {}
    Rt_prev_ref = None
    for name in sorted(chain):
        c = chain[name]
        fx, fy, cx, cy = c["intrinsics"]
        dist = c.get("distortion_coeffs", []) or []
        dm = c.get("distortion_model", "none")
        if dm == "radtan" and len(dist) >= 4:
            lm = "LENSMODEL_OPENCV4"
            intr = np.array([fx, fy, cx, cy] + list(dist[:4]))
        elif dm in ("none", None) or not dist:
            lm = "LENSMODEL_PINHOLE"
            intr = np.array([fx, fy, cx, cy])
        elif dm == "equidistant":
            raise SystemExit("equidistant (KANNALA_BRANDT) import not "
                             "supported")
        else:
            raise SystemExit(f"Unknown distortion model {dm}")
        W, H = c["resolution"]
        if "T_cn_cnm1" in c and Rt_prev_ref is not None:
            T = np.array(c["T_cn_cnm1"])
            Rt_cn_cnm1 = np.concatenate([T[:3, :3], T[:3, 3][None]], axis=0)
            Rt_cam_ref = host(poseutils.compose_Rt(Rt_cn_cnm1, Rt_prev_ref,
                                                   device=device))
        else:
            Rt_cam_ref = host(poseutils.identity_Rt(device=device))
        Rt_prev_ref = Rt_cam_ref
        m = cameramodel(
            intrinsics=(lm, intr), imagersize=(int(W), int(H)),
            rt_cam_ref=host(poseutils.rt_from_Rt(Rt_cam_ref, device=device)))
        fn = f"{a.outdir}/{name}.cameramodel"
        m.write(fn)
        print(f"Wrote {fn}")
        models[name] = m
    return models


if __name__ == "__main__":
    main()
