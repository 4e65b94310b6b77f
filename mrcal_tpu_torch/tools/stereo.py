"""Dense stereo processing: rectify a pair of images, correlate, report
ranges.

The port of tools/mrcal-stereo (reference: mrcal-stereo).  Pipeline:
rectified_system -> rectification_maps -> transform_image -> disparity
(the port's census+SGM matcher by default; OpenCV SGBM via --matcher
sgbm, which needs cv2) -> stereo_range -> outputs (rectified, disparity
and range images, optional point cloud); or, with --viz, a diagnostic
plot of the rectified geometry drawn by matplotlib.  Everything but SGBM,
the image files and the drawing runs on the CUDA card (device="cpu" from
Python runs it on the CPU).

    python -m mrcal_tpu_torch.tools.stereo --az-fov-deg 50 \\
        --el-fov-deg 40 --disparity-range 0 127 --range-image \\
        camera-0.cameramodel camera-1.cameramodel left.png right.png
"""

import argparse
import os
import sys

import numpy as np

from .._config import resolve_device
from ._common import host


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mrcal_tpu_torch.tools.stereo",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--az-fov-deg", type=float, required=True)
    p.add_argument("--el-fov-deg", type=float, required=True)
    p.add_argument("--az0-deg", type=float, default=None)
    p.add_argument("--el0-deg", type=float, default=0.0)
    p.add_argument("--az-edge-margin-deg", type=float, default=10.0,
                   help="margin to the azimuth edges when auto-centering "
                        "the rectified view (reference mrcal-stereo:227)")
    p.add_argument("--pixels-per-deg", type=float, default=-1.0)
    p.add_argument("--rectification",
                   choices=["LENSMODEL_LATLON", "LENSMODEL_PINHOLE"],
                   default="LENSMODEL_LATLON")
    p.add_argument("--already-rectified", action="store_true",
                   help="input images are already rectified with the "
                        "geometry implied by the models; skip remapping")
    p.add_argument("--clahe", action="store_true",
                   help="equalize the rectified images (adaptive "
                        "histogram equalization) before matching")
    p.add_argument("--equalization", choices=["clahe", "stretch"],
                   default=None,
                   help="equalization method for the input images: "
                        "'clahe' (same as --clahe) or 'stretch' (global "
                        "min/max contrast stretch).  The reference's "
                        "'fieldscale' needs mrcam and is not supported")
    p.add_argument("--force-grayscale", action="store_true",
                   help="convert images to grayscale before processing "
                        "(the census/NCC matchers consume grayscale, so "
                        "this is the effective default)")
    p.add_argument("--disparity-range", type=int, nargs=2, default=[0, 100])
    p.add_argument("--matcher", "--stereo-matcher", dest="matcher",
                   choices=["sgm", "sgbm", "ncc"], default="sgm",
                   help="sgm: built-in census+SGM (default); "
                        "sgbm: OpenCV StereoSGBM (needs cv2); "
                        "ncc: built-in block NCC")
    # native SGM tuning (census+SGM; see stereo_matching_sgm)
    p.add_argument("--sgm-p1", type=float, default=6.0)
    p.add_argument("--sgm-p2", type=float, default=96.0)
    p.add_argument("--sgm-lr-limit", type=int, default=1,
                   help="left-right consistency tolerance in px; "
                        "0 disables the check")
    # OpenCV SGBM knob matrix (reference mrcal-stereo:373-411)
    p.add_argument("--sgbm-block-size", type=int, default=5)
    p.add_argument("--sgbm-p1", type=int, default=None)
    p.add_argument("--sgbm-p2", type=int, default=None)
    p.add_argument("--sgbm-disp12-max-diff", type=int, default=1)
    p.add_argument("--sgbm-pre-filter-cap", type=int, default=0)
    p.add_argument("--sgbm-uniqueness-ratio", type=int, default=5)
    p.add_argument("--sgbm-speckle-window-size", type=int, default=50)
    p.add_argument("--sgbm-speckle-range", type=int, default=1)
    p.add_argument("--sgbm-mode", choices=["sgbm", "hh", "sgbm3way", "hh4"],
                   default="sgbm")
    p.add_argument("--valid-intrinsics-region", action="store_true",
                   help="mask out rectified pixels that fall outside "
                        "either model's valid-intrinsics region")
    p.add_argument("--range-image-limits", type=float, nargs=2,
                   default=None, metavar=("MIN", "MAX"),
                   help="color-map bounds of the range image")
    p.add_argument("--outdir", default=".")
    p.add_argument("--tag", default="stereo")
    p.add_argument("--force", "-f", action="store_true",
                   help="overwrite existing output files (by default "
                        "existing outputs abort the run, like the "
                        "reference)")
    p.add_argument("--jobs", "-j", type=int, default=1,
                   help="accepted for reference compatibility; the "
                        "matchers are batched on the device, so there is "
                        "nothing to parallelize on the host")
    p.add_argument("--verbose", action="store_true",
                   help="report per-stage diagnostics")
    p.add_argument("--axis-scale", type=float, default=None,
                   help="camera-axis scale for --viz geometry (default: "
                        "the stereo baseline)")
    p.add_argument("--title", default=None,
                   help="title for --viz plots")
    p.add_argument("--hardcopy", default=None,
                   help="write the --viz plot to this file instead of "
                        "the default OUTDIR/TAG-*.png path")
    p.add_argument("--range-image", action="store_true")
    p.add_argument("--write-point-cloud", action="store_true")
    p.add_argument("--viz", choices=["geometry", "rectification"],
                   default=None,
                   help="write a diagnostic plot instead of running the "
                        "full pipeline: 'geometry' (cameras + rectified "
                        "pair in 3D), 'rectification' (the rectified "
                        "field of view over each input image)")
    p.add_argument("--roi", type=int, nargs=4, default=None,
                   metavar=("X0", "Y0", "W", "H"),
                   help="only correlate this rectangle of the rectified "
                        "image (faster; everything else reports 0 "
                        "disparity)")
    p.add_argument("models", nargs=2)
    p.add_argument("images", nargs=2)
    return p.parse_args(argv)


def disparity_sgbm(rect0, rect1, args):
    """SGBM via OpenCV (same engine the reference drives), returning scaled
    disparity (x16); full reference knob matrix."""
    import cv2
    bs = args.sgbm_block_size
    num = ((args.disparity_range[1] - args.disparity_range[0] + 15)
           // 16) * 16
    mode = dict(sgbm=cv2.STEREO_SGBM_MODE_SGBM,
                hh=cv2.STEREO_SGBM_MODE_HH,
                sgbm3way=cv2.STEREO_SGBM_MODE_SGBM_3WAY,
                hh4=getattr(cv2, "STEREO_SGBM_MODE_HH4",
                            cv2.STEREO_SGBM_MODE_HH))[args.sgbm_mode]
    sgbm = cv2.StereoSGBM_create(
        minDisparity=args.disparity_range[0],
        numDisparities=num,
        blockSize=bs,
        P1=args.sgbm_p1 if args.sgbm_p1 is not None else 8 * bs * bs,
        P2=args.sgbm_p2 if args.sgbm_p2 is not None else 32 * bs * bs,
        disp12MaxDiff=args.sgbm_disp12_max_diff,
        preFilterCap=args.sgbm_pre_filter_cap,
        uniquenessRatio=args.sgbm_uniqueness_ratio,
        speckleWindowSize=args.sgbm_speckle_window_size,
        speckleRange=args.sgbm_speckle_range,
        mode=mode)
    return sgbm.compute(rect0, rect1)   # int16, x16 scale


def rectify(models, args, device):
    """The rectified system of the options: (rect_models, metadata)."""
    import mrcal_tpu_torch as mrcal
    return mrcal.rectified_system(
        models, az_fov_deg=args.az_fov_deg, el_fov_deg=args.el_fov_deg,
        az0_deg=args.az0_deg, el0_deg=args.el0_deg,
        az_edge_margin_deg=args.az_edge_margin_deg,
        pixels_per_deg_az=args.pixels_per_deg,
        pixels_per_deg_el=args.pixels_per_deg,
        rectification_model=args.rectification,
        return_metadata=True, device=device)


def report_rectification(meta):
    print(f"## baseline {meta['baseline']:.4f}; "
          f"az0 {meta['az0_deg']:.2f} deg; "
          f"{meta['pixels_per_deg_az']:.2f} px/deg")


def viz(models, args, device, check_overwrite):
    """--viz: the rectified system, then its plot written to --hardcopy
    (OUTDIR/TAG-geometry.png or OUTDIR/TAG-rectification.png by default):
    'geometry' the two cameras and the rectified pair in 3D,
    'rectification' every 20th rectified pixel's position in each input
    image.  Returns dict(rect_models, meta, hardcopy)."""
    import mrcal_tpu_torch as mrcal
    rect_models, meta = rectify(models, args, device)
    report_rectification(meta)
    if args.viz == "geometry":
        out = check_overwrite(args.hardcopy or
                              f"{args.outdir}/{args.tag}-geometry.png")
        mrcal.show_geometry(list(models) + list(rect_models),
                            cameranames=["cam0", "cam1", "rect0", "rect1"],
                            axis_scale=(args.axis_scale if args.axis_scale
                                        is not None
                                        else float(meta["baseline"])),
                            title=args.title or "stereo geometry",
                            hardcopy=out, device=device)
    else:
        maps = [host(m) for m in mrcal.rectification_maps(
            models, rect_models, device=device)]
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axs = plt.subplots(1, 2, figsize=(12, 5))
        for i in range(2):
            img = mrcal.load_image(args.images[i], bits_per_pixel=8,
                                   channels=1)
            m = maps[i]                        # (H,W,2) input-pixel coords
            axs[i].imshow(np.asarray(img), cmap="gray")
            axs[i].plot(m[::20, ::20, 0].ravel(), m[::20, ::20, 1].ravel(),
                        ".", ms=1, color="red", alpha=0.5)
            axs[i].set_title(f"camera {i}: rectified grid")
        if args.title:
            fig.suptitle(args.title)
        out = check_overwrite(
            args.hardcopy or f"{args.outdir}/{args.tag}-rectification.png")
        fig.savefig(out, dpi=120)
    print(f"## wrote {out}")
    return dict(rect_models=rect_models, meta=meta, hardcopy=out)


def stereo(models, images, args, device):
    """mrcal-stereo's computation on arrays: the two models, the two 8-bit
    grayscale images (already rectified with --already-rectified) and the
    parsed options.  Returns a dict, numpy: rect_models, meta (the
    rectification's metadata), rectified (the two matched
    images before equalization), disparity (scaled by disparity_scale),
    disparity_scale, disparity_image (the colored disparity), ranges,
    range_image (with --range-image) and points (the valid pixels' 3D
    points, with --write-point-cloud)."""
    import mrcal_tpu_torch as mrcal
    from ..image import apply_color_map, clahe_equalize, stretch_equalize

    def vlog(msg):
        if args.verbose:
            print(f"## {msg}", file=sys.stderr)

    rect_models, meta = rectify(models, args, device)
    if args.already_rectified:
        rectified = [np.asarray(im) for im in images]
    else:
        maps = mrcal.rectification_maps(models, rect_models, device=device)
        rectified = [mrcal.transform_image(images[i], maps[i], device=device)
                     for i in range(2)]
        vlog("rectified both images")
    out = dict(rect_models=rect_models, meta=meta, rectified=rectified)
    if args.clahe or args.equalization == "clahe":
        rectified = [clahe_equalize(im) for im in rectified]
        vlog("applied CLAHE equalization")
    elif args.equalization == "stretch":
        rectified = [stretch_equalize(im) for im in rectified]
        vlog("applied contrast stretch")
    match_input = rectified
    if args.roi is not None:
        x0, y0, w, h = args.roi
        match_input = [np.asarray(im)[y0:y0 + h, x0:x0 + w]
                       for im in rectified]

    if args.matcher == "sgbm":
        disp_scaled = disparity_sgbm(np.asarray(match_input[0]),
                                     np.asarray(match_input[1]), args)
        disparity_scale = 16
    elif args.matcher == "ncc":
        disp_scaled = host(mrcal.stereo_matching_ncc(
            match_input[0], match_input[1],
            disparity_min=args.disparity_range[0],
            disparity_max=args.disparity_range[1], device=device))
        disparity_scale = 1
    else:
        disp_scaled = host(mrcal.stereo_matching_sgm(
            match_input[0], match_input[1],
            disparity_min=args.disparity_range[0],
            disparity_max=args.disparity_range[1],
            P1=args.sgm_p1, P2=args.sgm_p2,
            lr_consistency_threshold=args.sgm_lr_limit, device=device))
        disparity_scale = 1
    if args.roi is not None:
        x0, y0, w, h = args.roi
        full = np.zeros(np.asarray(rectified[0]).shape,
                        dtype=disp_scaled.dtype)
        full[y0:y0 + h, x0:x0 + w] = disp_scaled
        disp_scaled = full

    if args.valid_intrinsics_region and not args.already_rectified:
        # mask rectified pixels whose source pixel falls outside either
        # camera's valid-intrinsics region (reference mrcal-stereo:349)
        keep = np.ones(disp_scaled.shape, bool)
        for i in range(2):
            if models[i].valid_intrinsics_region() is None:
                continue
            ok = host(mrcal.is_within_valid_intrinsics_region(
                maps[i].reshape(-1, 2), models[i], device=device))
            keep &= ok.reshape(keep.shape)
        disp_scaled = np.where(keep, disp_scaled, 0)

    vlog(f"matcher '{args.matcher}' done: "
         f"{int(np.sum(disp_scaled > 0))} valid px")
    disp_vis = np.clip(
        disp_scaled.astype(np.float32) / disparity_scale, 0, None)
    out.update(disparity=disp_scaled, disparity_scale=disparity_scale,
               disparity_image=host(apply_color_map(
                   disp_vis, a_min=args.disparity_range[0],
                   a_max=args.disparity_range[1], device=device)))

    ranges = host(mrcal.stereo_range(
        disp_scaled.astype(np.float64), rect_models,
        disparity_scale=disparity_scale,
        disparity_min=max(args.disparity_range[0], 1e-3), device=device))
    out["ranges"] = ranges
    if args.range_image:
        lim = args.range_image_limits
        out["range_image"] = host(apply_color_map(
            np.where(ranges > 0, ranges, 0),
            a_min=(lim[0] if lim else None),
            a_max=(lim[1] if lim else None), device=device))
    if args.write_point_cloud:
        p = host(mrcal.stereo_unproject(None, rect_models, ranges=ranges,
                                        device=device))
        out["points"] = p[ranges > 0]
    return out


def main(argv=None, *, device=None):
    """The tool on `argv`, on `device` (the card unless "cpu").  Returns
    stereo()'s dict (viz()'s with --viz)."""
    args = parse_args(argv)
    device = resolve_device(device)
    import mrcal_tpu_torch as mrcal

    def check_overwrite(path):
        if not args.force and os.path.exists(path):
            print(f"'{path}' already exists. Not overwriting; pass "
                  "--force to overwrite", file=sys.stderr)
            sys.exit(1)
        return path

    models = [mrcal.cameramodel(f) for f in args.models]
    if args.viz is not None:
        return viz(models, args, device, check_overwrite)
    images = [mrcal.load_image(f, bits_per_pixel=8, channels=1)
              for f in args.images]
    out = stereo(models, images, args, device)
    report_rectification(out["meta"])
    if not args.already_rectified:
        for i in range(2):
            mrcal.save_image(
                check_overwrite(f"{args.outdir}/{args.tag}-rectified{i}.png"),
                out["rectified"][i])
    mrcal.save_image(
        check_overwrite(f"{args.outdir}/{args.tag}-disparity.png"),
        out["disparity_image"])
    if args.range_image:
        mrcal.save_image(
            check_overwrite(f"{args.outdir}/{args.tag}-range.png"),
            out["range_image"])
    if args.write_point_cloud:
        pts = out["points"]
        with open(check_overwrite(f"{args.outdir}/{args.tag}.ply"),
                  "w") as f:
            f.write("ply\nformat ascii 1.0\n"
                    f"element vertex {len(pts)}\n"
                    "property float x\nproperty float y\nproperty float z\n"
                    "end_header\n")
            np.savetxt(f, pts, fmt="%.4f")
    print(f"## wrote outputs to {args.outdir}/{args.tag}-*")
    return out


if __name__ == "__main__":
    main()
