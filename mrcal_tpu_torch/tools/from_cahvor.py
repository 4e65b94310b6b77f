"""Convert a legacy .cahvor file to the .cameramodel format.

The port of tools/mrcal-from-cahvor: reads the .cahvor file (or standard
input for '-') and writes the .cameramodel text on standard output.

    python -m mrcal_tpu_torch.tools.from_cahvor camera.cahvor
"""

import argparse
import sys

from .._config import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mrcal_tpu_torch.tools.from_cahvor",
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
    m = cahvor.read(a.model) if a.model != "-" else cahvor.read(sys.stdin)
    m.write(sys.stdout)
    return m


if __name__ == "__main__":
    main()
