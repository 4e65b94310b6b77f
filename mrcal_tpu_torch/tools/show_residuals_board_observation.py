"""Residuals for specific board observations.

The port of tools/mrcal-show-residuals-board-observation: the residual
vectorfield of each given observation of the calibration the model holds.
With several observations, --hardcopy a.png writes a-<i>.png for each.
The residuals are computed on the CUDA card (device="cpu" from Python
computes them on the CPU); matplotlib draws.

    python -m mrcal_tpu_torch.tools.show_residuals_board_observation \\
        --hardcopy observation.png camera-0.cameramodel 0 5
"""

import argparse

from .._config import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mrcal_tpu_torch.tools."
             "show_residuals_board_observation",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--hardcopy", type=str, default=None)
    p.add_argument("model")
    p.add_argument("i_observations", nargs="+", type=int)
    return p.parse_args(argv)


def main(argv=None, *, device=None):
    """The tool on `argv`, on `device` (the card unless "cpu").  Returns
    the figures, one per observation."""
    a = parse_args(argv)
    device = resolve_device(device)
    import mrcal_tpu_torch as mrcal
    m = mrcal.cameramodel(a.model)
    oi = m.optimization_inputs()
    figures = []
    for i in a.i_observations:
        hc = a.hardcopy
        if hc and len(a.i_observations) > 1:
            hc = hc.replace(".", f"-{i}.", 1)
        figures.append(mrcal.show_residuals_board_observation(
            oi, i, hardcopy=hc, device=device))
    return figures


if __name__ == "__main__":
    main()
