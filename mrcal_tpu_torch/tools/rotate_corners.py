"""Rotate the chessboard corner ordering in a corners.vnl by 90, 180 or
270 degrees.

The port of tools/mrcal-rotate-corners (reference: mrcal-rotate-corners):
reads the file (or standard input for '-') and writes standard output;
an image whose row count is not the board's is copied as it is.

    python -m mrcal_tpu_torch.tools.rotate_corners --rot 90 \\
        --object-width-n 14 corners.vnl > rotated.vnl
"""

import argparse
import sys

import numpy as np

from .._config import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mrcal_tpu_torch.tools.rotate_corners",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--rot", type=int, required=True, choices=[90, 180, 270])
    p.add_argument("--object-width-n", type=int, required=True)
    p.add_argument("--object-height-n", type=int, default=None)
    p.add_argument("corners", nargs="?", default="-")
    return p.parse_args(argv)


def main(argv=None, *, device=None):
    """The tool on `argv`.  The text is host data; `device` is checked as
    every tool checks it (the card unless "cpu")."""
    a = parse_args(argv)
    resolve_device(device)
    W = a.object_width_n
    H = a.object_height_n or W
    f = sys.stdin if a.corners == "-" else open(a.corners)
    rows = {}
    header = []
    try:
        for line in f:
            if line.startswith("#") or not line.strip():
                header.append(line)
                continue
            fields = line.split()
            rows.setdefault(fields[0], []).append(fields)
    finally:
        if f is not sys.stdin:
            f.close()
    sys.stdout.writelines(header)
    for rs in rows.values():
        if len(rs) != W * H:
            for r in rs:
                print(" ".join(r))
            continue
        grid = np.array(rs, dtype=object).reshape(H, W, -1)
        k = a.rot // 90
        grid = np.rot90(grid, k=k, axes=(0, 1))
        for r in grid.reshape(-1, grid.shape[-1]):
            print(" ".join(str(x) for x in r))


if __name__ == "__main__":
    main()
