"""Show the angular resolution of a model over its imager.

The port of tools/mrcal-show-model-resolution: the largest singular value
of the unprojection's gradient over a grid, in degrees per pixel,
computed on the CUDA card (device="cpu" from Python computes it on the
CPU); its range is printed, and matplotlib draws it.

    python -m mrcal_tpu_torch.tools.show_model_resolution \\
        --hardcopy resolution.png camera-0.cameramodel
"""

import argparse

from .._config import resolve_device
from ._common import host


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mrcal_tpu_torch.tools.show_model_resolution",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--hardcopy", type=str, default=None)
    p.add_argument("--gridn", type=int, nargs=2, default=[40, None])
    p.add_argument("model")
    return p.parse_args(argv)


def main(argv=None, *, device=None):
    """The tool on `argv`, on `device` (the card unless "cpu").  Returns
    (the figure, the resolution grid in deg/pixel)."""
    a = parse_args(argv)
    device = resolve_device(device)
    import mrcal_tpu_torch as mrcal
    m = mrcal.cameramodel(a.model)
    res = host(mrcal.model_resolution__deg_pixel(
        m, gridn_width=a.gridn[0], gridn_height=a.gridn[1], device=device))
    # the report comes first: a machine without matplotlib still gets it
    print(f"resolution range: {res.min():.5f} .. {res.max():.5f} deg/pixel")
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots()
    im = ax.imshow(res)
    fig.colorbar(im, ax=ax, label="deg/pixel")
    if a.hardcopy:
        fig.savefig(a.hardcopy, dpi=120)
    return fig, res


if __name__ == "__main__":
    main()
