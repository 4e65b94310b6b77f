"""Visualize the geometry of camera models.

The port of tools/mrcal-show-geometry: the cameras' poses (and, from a
model that holds its optimization_inputs, the calibration's boards) in a
3D plot.  The poses are computed on the CUDA card (device="cpu" from
Python computes them on the CPU); matplotlib draws.  Without --hardcopy
the plot is written to standard output as a PNG.

    python -m mrcal_tpu_torch.tools.show_geometry --hardcopy geometry.png \\
        camera-0.cameramodel camera-1.cameramodel
"""

import argparse
import sys

from .._config import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mrcal_tpu_torch.tools.show_geometry",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--hardcopy", type=str, default=None)
    p.add_argument("--axis-scale", type=float, default=1.0)
    p.add_argument("--show-calobjects", action="store_true")
    p.add_argument("models", nargs="+")
    return p.parse_args(argv)


def main(argv=None, *, device=None):
    """The tool on `argv`, on `device` (the card unless "cpu").  Returns
    the figure."""
    a = parse_args(argv)
    device = resolve_device(device)
    import mrcal_tpu_torch as mrcal
    models = [mrcal.cameramodel(f) for f in a.models]
    kw = {}
    if a.show_calobjects:
        oi = models[0].optimization_inputs()
        if oi is not None:
            kw = dict(frames_rt_toref=oi["frames_rt_toref"],
                      object_width_n=oi["observations_board"].shape[-2],
                      object_height_n=oi["observations_board"].shape[-3],
                      object_spacing=oi["calibration_object_spacing"])
    fig = mrcal.show_geometry(models, axis_scale=a.axis_scale,
                              hardcopy=a.hardcopy, device=device, **kw)
    if not a.hardcopy:
        sys.stdout.flush()
        fig.savefig(getattr(sys.stdout, "buffer", "/dev/stdout"),
                    format="png")
    return fig


if __name__ == "__main__":
    main()
