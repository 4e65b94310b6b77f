"""Filter a corners.vnl: throw out some data.

The port of tools/mrcal-cull-corners (reference: mrcal-cull-corners):
drops the rows of the images that --exclude-images matches, and marks as
outliers (level -1) the corners farther than --cull-rad-off-center from
the imager's center; reads the file (or standard input for '-') and
writes standard output.

    python -m mrcal_tpu_torch.tools.cull_corners --imagersize 800 600 \\
        --cull-rad-off-center 300 corners.vnl > culled.vnl
"""

import argparse
import fnmatch
import sys

from .._config import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mrcal_tpu_torch.tools.cull_corners",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--exclude-images", type=str, default=None,
                   help="glob of image filenames to cull")
    p.add_argument("--cull-rad-off-center", type=float, default=None)
    p.add_argument("--imagersize", type=int, nargs=2, default=None)
    p.add_argument("corners", nargs="?", default="-")
    return p.parse_args(argv)


def cull(lines, a):
    """The lines of a corners.vnl kept, and marked, by the options a."""
    for line in lines:
        if line.startswith("#") or not line.strip():
            yield line
            continue
        fields = line.split()
        if a.exclude_images and fnmatch.fnmatch(fields[0], a.exclude_images):
            continue
        if a.cull_rad_off_center is not None and a.imagersize and \
                len(fields) >= 3 and fields[1] != "-":
            cx = (a.imagersize[0] - 1) / 2
            cy = (a.imagersize[1] - 1) / 2
            dx = float(fields[1]) - cx
            dy = float(fields[2]) - cy
            if (dx * dx + dy * dy) > a.cull_rad_off_center ** 2:
                # mark as outlier by setting level < 0
                if len(fields) > 3:
                    fields[3] = "-1"
                    line = " ".join(fields) + "\n"
                else:
                    continue
        yield line


def main(argv=None, *, device=None):
    """The tool on `argv`.  The text is host data; `device` is checked as
    every tool checks it (the card unless "cpu")."""
    a = parse_args(argv)
    resolve_device(device)
    f = sys.stdin if a.corners == "-" else open(a.corners)
    try:
        sys.stdout.writelines(cull(f, a))
    finally:
        if f is not sys.stdin:
            f.close()


if __name__ == "__main__":
    main()
