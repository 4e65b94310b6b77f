"""Show the valid-intrinsics region of model(s).

The port of tools/mrcal-show-valid-intrinsics-region: the models'
valid-intrinsics regions, over --image if given, drawn by matplotlib.
(Nothing here is computed on the device; the tool takes it as the others
do, the CUDA card unless device="cpu" from Python.)

    python -m mrcal_tpu_torch.tools.show_valid_intrinsics_region \\
        --hardcopy region.png camera-0.cameramodel
"""

import argparse

from .._config import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mrcal_tpu_torch.tools.show_valid_intrinsics_region",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--hardcopy", type=str, default=None)
    p.add_argument("--image", type=str, default=None)
    p.add_argument("models", nargs="+")
    return p.parse_args(argv)


def main(argv=None, *, device=None):
    """The tool on `argv`, on `device` (the card unless "cpu").  Returns
    the figure."""
    a = parse_args(argv)
    device = resolve_device(device)
    import mrcal_tpu_torch as mrcal
    models = [mrcal.cameramodel(f) for f in a.models]
    return mrcal.show_valid_intrinsics_region(
        models, image=a.image, hardcopy=a.hardcopy, device=device)


if __name__ == "__main__":
    main()
