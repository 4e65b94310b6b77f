"""Show lens distortion relative to a pinhole projection.

The port of tools/mrcal-show-distortion-off-pinhole: how far the model's
projection is from that of its pinhole core over the imager (a heatmap,
or --vectorfield), or along the imager's diagonal (--radial).  The
projections run on the CUDA card (device="cpu" from Python runs them on
the CPU); matplotlib draws.

    python -m mrcal_tpu_torch.tools.show_distortion_off_pinhole \\
        --hardcopy distortion.png camera-0.cameramodel
"""

import argparse

from .._config import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mrcal_tpu_torch.tools.show_distortion_off_pinhole",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--hardcopy", type=str, default=None)
    p.add_argument("--vectorfield", action="store_true")
    p.add_argument("--radial", action="store_true")
    p.add_argument("model")
    return p.parse_args(argv)


def main(argv=None, *, device=None):
    """The tool on `argv`, on `device` (the card unless "cpu").  Returns
    the figure."""
    a = parse_args(argv)
    device = resolve_device(device)
    import mrcal_tpu_torch as mrcal
    m = mrcal.cameramodel(a.model)
    if a.radial:
        return mrcal.show_distortion_off_pinhole_radial(
            m, hardcopy=a.hardcopy, device=device)
    return mrcal.show_distortion_off_pinhole(
        m, vectorfield=a.vectorfield, hardcopy=a.hardcopy, device=device)


if __name__ == "__main__":
    main()
