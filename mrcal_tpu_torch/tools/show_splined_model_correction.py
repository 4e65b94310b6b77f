"""Show the spline correction surface of a splined model.

The port of tools/mrcal-show-splined-model-correction: |deltau| of a
LENSMODEL_SPLINED_STEREOGRAPHIC model over the imager, or its
--vectorfield, computed on the CUDA card (device="cpu" from Python
computes it on the CPU); matplotlib draws.

    python -m mrcal_tpu_torch.tools.show_splined_model_correction \\
        --hardcopy correction.png splined.cameramodel
"""

import argparse

from .._config import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mrcal_tpu_torch.tools.show_splined_model_correction",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--hardcopy", type=str, default=None)
    p.add_argument("--vectorfield", action="store_true")
    p.add_argument("model")
    return p.parse_args(argv)


def main(argv=None, *, device=None):
    """The tool on `argv`, on `device` (the card unless "cpu").  Returns
    the figure."""
    a = parse_args(argv)
    device = resolve_device(device)
    import mrcal_tpu_torch as mrcal
    m = mrcal.cameramodel(a.model)
    return mrcal.show_splined_model_correction(
        m, vectorfield=a.vectorfield, hardcopy=a.hardcopy, device=device)


if __name__ == "__main__":
    main()
