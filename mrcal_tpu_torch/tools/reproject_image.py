"""Remap an image from one lens model to another.

The port of tools/mrcal-reproject-image (reference: mrcal-reproject-image):
the image of model_from as model_to (or, with --to-pinhole, a pinhole
model fitted to model_from) would see it.  The map and the remap run on
the CUDA card (device="cpu" from Python runs them on the CPU); the image
files are read and written with PIL.

    python -m mrcal_tpu_torch.tools.reproject_image --to-pinhole \\
        --outfile pinhole.png camera-0.cameramodel image.png
"""

import argparse

from .._config import resolve_device
from ._common import host


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mrcal_tpu_torch.tools.reproject_image",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--to-pinhole", action="store_true")
    p.add_argument("--fit", default=None,
                   help="corners | centers-horizontal | centers-vertical")
    p.add_argument("--intrinsics-only", action="store_true")
    p.add_argument("--distance", type=float, default=None)
    p.add_argument("--outfile", required=True)
    p.add_argument("model_from")
    p.add_argument("model_to_or_image")
    p.add_argument("image", nargs="?", default=None)
    return p.parse_args(argv)


def reproject_image(image, m_from, m_to=None, *, fit=None,
                    intrinsics_only=False, distance=None, device):
    """The image (an array) of m_from reprojected into m_to (None: the
    pinhole model fitted to m_from by `fit`).  Returns (image, the (H, W,
    2) map), numpy."""
    import mrcal_tpu_torch as mrcal
    if m_to is None:
        m_to = mrcal.pinhole_model_for_reprojection(m_from, fit=fit,
                                                    device=device)
    mapxy = mrcal.image_transformation_map(
        m_from, m_to, intrinsics_only=intrinsics_only, distance=distance,
        device=device)
    return mrcal.transform_image(image, mapxy, device=device), host(mapxy)


def main(argv=None, *, device=None):
    """The tool on `argv`, on `device` (the card unless "cpu").  Returns
    the reprojected image."""
    a = parse_args(argv)
    device = resolve_device(device)
    import mrcal_tpu_torch as mrcal
    m_from = mrcal.cameramodel(a.model_from)
    if a.to_pinhole:
        m_to = None
        imagefile = a.model_to_or_image
    else:
        m_to = mrcal.cameramodel(a.model_to_or_image)
        imagefile = a.image
    img = mrcal.load_image(imagefile)
    out, _ = reproject_image(img, m_from, m_to, fit=a.fit,
                             intrinsics_only=a.intrinsics_only,
                             distance=a.distance, device=device)
    mrcal.save_image(a.outfile, out)
    print(f"Wrote {a.outfile}")
    return out


if __name__ == "__main__":
    main()
