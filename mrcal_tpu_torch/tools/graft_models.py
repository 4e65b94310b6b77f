"""Combine the intrinsics of one model with the extrinsics of another.

The port of tools/mrcal-graft-models (reference: mrcal-graft-models):
writes the grafted model on standard output.

    python -m mrcal_tpu_torch.tools.graft_models intrinsics.cameramodel \\
        extrinsics.cameramodel > grafted.cameramodel
"""

import argparse
import sys

from .._config import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mrcal_tpu_torch.tools.graft_models",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model_intrinsics")
    p.add_argument("model_extrinsics")
    return p.parse_args(argv)


def main(argv=None, *, device=None):
    """The tool on `argv`.  The models are host data; `device` is checked
    as every tool checks it (the card unless "cpu").  Returns the grafted
    model."""
    a = parse_args(argv)
    resolve_device(device)
    from ..cameramodel import cameramodel
    mi = cameramodel(a.model_intrinsics)
    me = cameramodel(a.model_extrinsics)
    mi.extrinsics_rt_fromref(me.extrinsics_rt_fromref())
    mi.write(sys.stdout)
    return mi


if __name__ == "__main__":
    main()
