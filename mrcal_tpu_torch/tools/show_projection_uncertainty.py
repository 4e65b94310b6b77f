"""Projection-uncertainty heatmap for a model.

The port of tools/mrcal-show-projection-uncertainty: the projection's
uncertainty from the calibration's noise over the imager, or against the
range along one pixel's ray (--vs-distance-at).  The model must hold its
optimization_inputs.  Computed on the CUDA card (device="cpu" from
Python computes it on the CPU); matplotlib draws.

    python -m mrcal_tpu_torch.tools.show_projection_uncertainty \\
        --hardcopy uncertainty.png camera-0.cameramodel
"""

import argparse

from .._config import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mrcal_tpu_torch.tools.show_projection_uncertainty",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--hardcopy", type=str, default=None)
    p.add_argument("--distance", type=float, default=None)
    p.add_argument("--gridn", type=int, nargs=2, default=[30, None])
    p.add_argument("--isotropic", action="store_true")
    p.add_argument("--method", type=str, default="mean-pcam",
                   choices=["mean-pcam", "cross-reprojection-ccp",
                            "cross-reprojection-rrp-Jfp"])
    p.add_argument("--cbmax", type=float, default=3)
    p.add_argument("--vs-distance-at", type=str, default=None,
                   help="'centroid' or 'x,y': plot uncertainty vs distance")
    p.add_argument("model")
    return p.parse_args(argv)


def main(argv=None, *, device=None):
    """The tool on `argv`, on `device` (the card unless "cpu").  Returns
    (the figure, the uncertainty)."""
    a = parse_args(argv)
    device = resolve_device(device)
    import mrcal_tpu_torch as mrcal
    m = mrcal.cameramodel(a.model)
    if a.vs_distance_at is not None:
        where = a.vs_distance_at
        if "," in where:
            where = [float(v) for v in where.split(",")]
        return mrcal.show_projection_uncertainty_vs_distance(
            m, where=where, method=a.method, hardcopy=a.hardcopy,
            device=device)
    return mrcal.show_projection_uncertainty(
        m, gridn_width=a.gridn[0], gridn_height=a.gridn[1],
        distance=a.distance, isotropic=a.isotropic, cbmax=a.cbmax,
        method=a.method, hardcopy=a.hardcopy, device=device)


if __name__ == "__main__":
    main()
