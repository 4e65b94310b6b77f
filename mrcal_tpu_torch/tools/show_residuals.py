"""Visualize calibration residuals.

The port of tools/mrcal-show-residuals: the residuals of the model's
camera in the calibration it holds (its optimization_inputs), as a
vectorfield over the imager (the default), their --magnitudes,
--directions, --regional means or a --histogram.  The residuals are
computed on the CUDA card (device="cpu" from Python computes them on the
CPU); matplotlib draws.

    python -m mrcal_tpu_torch.tools.show_residuals --histogram \\
        --hardcopy residuals.png camera-0.cameramodel
"""

import argparse

from .._config import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mrcal_tpu_torch.tools.show_residuals",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--hardcopy", type=str, default=None)
    p.add_argument("--vectorfield", action="store_true")
    p.add_argument("--magnitudes", action="store_true")
    p.add_argument("--directions", action="store_true")
    p.add_argument("--regional", action="store_true")
    p.add_argument("--histogram", action="store_true")
    p.add_argument("model")
    return p.parse_args(argv)


def main(argv=None, *, device=None):
    """The tool on `argv`, on `device` (the card unless "cpu").  Returns
    what the show_* function returns."""
    a = parse_args(argv)
    device = resolve_device(device)
    import mrcal_tpu_torch as mrcal
    m = mrcal.cameramodel(a.model)
    oi = m.optimization_inputs()
    if oi is None:
        raise SystemExit("model has no optimization_inputs")
    icam = m.icam_intrinsics()
    if a.histogram:
        show = mrcal.show_residuals_histogram
    elif a.magnitudes:
        show = mrcal.show_residuals_magnitudes
    elif a.directions:
        show = mrcal.show_residuals_directions
    elif a.regional:
        show = mrcal.show_residuals_regional
    else:
        show = mrcal.show_residuals_vectorfield
    return show(oi, icam_intrinsics=icam, hardcopy=a.hardcopy,
                device=device)


if __name__ == "__main__":
    main()
