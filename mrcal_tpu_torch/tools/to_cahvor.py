"""Convert a .cameramodel to the legacy .cahvor format.

The port of tools/mrcal-to-cahvor: reads the model (a file, or standard
input for '-') and writes the .cahvor text on standard output.

    python -m mrcal_tpu_torch.tools.to_cahvor camera.cameramodel
"""

import argparse
import sys

from .._config import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mrcal_tpu_torch.tools.to_cahvor",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model", nargs="?", default="-")
    return p.parse_args(argv)


def main(argv=None, *, device=None):
    """The tool on `argv`.  The models are host data; `device` is checked
    as every tool checks it (the card unless "cpu").  Returns the model."""
    a = parse_args(argv)
    resolve_device(device)
    from .. import cahvor
    from ..cameramodel import cameramodel
    m = cameramodel(a.model) if a.model != "-" else cameramodel(sys.stdin)
    cahvor.write(sys.stdout, m)
    return m


if __name__ == "__main__":
    main()
