"""Calibrate cameras from chessboard observations.

The port of tools/mrcal-calibrate-cameras: parse corners, seed
(stereographic guess + PnP + pose graph OR --seed models), staged solves
(geometry-only -> +stereographic core -> splined fxycxy-reset ->
everything-but-warp -> final with warp), full outlier rejection, write
.cameramodel files embedding the complete optimization_inputs; with
--explore, an interactive shell with the solve and the show_* plots in
scope (IPython if it imports, else the standard library's).  Every solve
and every plot's data runs on the CUDA card (device="cpu" from Python
runs them on the CPU).

    python -m mrcal_tpu_torch.tools.calibrate_cameras \\
        --corners-cache corners.vnl --lensmodel LENSMODEL_OPENCV8 \\
        --focal 700 --imagersize 800 600 --object-spacing 0.077 \\
        --object-width-n 14 '*-cam0.png' '*-cam1.png'
"""

import argparse
import re
import sys

import numpy as np

from .._config import resolve_device
from ._common import host


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mrcal_tpu_torch.tools.calibrate_cameras",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--corners-cache", type=str, required=True,
                   help="corners.vnl file (vnlog: filename x y level)")
    p.add_argument("--lensmodel", type=str, default="LENSMODEL_OPENCV8")
    p.add_argument("--focal", type=float, default=None,
                   help="initial focal-length estimate, pixels. Exactly "
                        "one of --focal and --seed must be given")
    p.add_argument("--seed", type=str, default=None,
                   help="comma-separated .cameramodel files to seed from "
                        "(intrinsics AND extrinsics); replaces --focal")
    p.add_argument("--object-spacing", type=float, required=True)
    p.add_argument("--object-width-n", type=int, required=True)
    p.add_argument("--object-height-n", type=int, default=None)
    p.add_argument("--imagersize", type=int, nargs=2, default=None)
    p.add_argument("--outdir", type=str, default=".")
    p.add_argument("--out-prefix", type=str, default="camera")
    p.add_argument("--skip-outlier-rejection", action="store_true")
    p.add_argument("--skip-regularization", action="store_true")
    p.add_argument("--skip-calobject-warp-solve", action="store_true")
    p.add_argument("--skip-intrinsics-solve", action="store_true")
    p.add_argument("--skip-extrinsics-solve", action="store_true")
    p.add_argument("--valid-intrinsics-region", action="store_true",
                   help="compute and store the valid-intrinsics region")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--explore", action="store_true",
                   help="after the solve, drop into an interactive "
                        "Python shell with the solved models, "
                        "optimization_inputs, stats, and show_* plotting "
                        "helpers in scope")
    p.add_argument("globs", nargs="+",
                   help="one glob per camera matching image filenames")
    a = p.parse_args(argv)
    if (a.focal is None) == (a.seed is None):
        p.error("exactly one of --focal and --seed must be given")
    return a


def expand_intrinsics(lensmodel, intrinsics_data, rng):
    """Append near-zero distortion seeds; damp the RATIONAL terms of
    OPENCV>=8 hard (k5..k7 ~ 0 keeps the denominator ~1 and the gradients
    well-behaved; reference mrcal-calibrate-cameras:602-627)."""
    from ..lensmodels import lensmodel_num_params
    Ncameras = len(intrinsics_data)
    Nnew = lensmodel_num_params(lensmodel) - intrinsics_data.shape[-1]
    new = (rng.random((Ncameras, Nnew)) - 0.5) * 2e-6
    m = re.search("OPENCV([0-9]+)", lensmodel)
    if m and int(m.group(1)) >= 8:
        new[..., 5:8] *= 1e-3
    return np.concatenate([intrinsics_data, new], axis=-1)


def _indices(indices_frame_camera):
    """(frame, camera) -> (frame, camintrinsics, camextrinsics), camera 0
    at the reference."""
    return np.concatenate(
        [indices_frame_camera,
         (indices_frame_camera[:, 1] - 1)[:, None]], axis=1).astype(np.int32)


def solve_initial(args, observations, indices_frame_camera, imagersizes,
                  seedmodels, device):
    """Staged seed solves (reference mrcal-calibrate-cameras:386-670).
    Returns (intrinsics_4 or seed-model intrinsics, rt_cam_ref,
    rt_ref_frame, seed_lensmodel)."""
    import mrcal_tpu_torch as mrcal
    indices = _indices(indices_frame_camera)

    def stage(label, **oi):
        print(f"## initial solve: {label}")
        stats = mrcal.optimize(device=device, **oi)
        print(f"## RMS error: {stats['rms_reproj_error__pixels']:.2f}")
        return stats

    if seedmodels is None:
        intr, ext, frames = mrcal.seed_stereographic(
            imagersizes=imagersizes, focal_estimate=args.focal,
            indices_frame_camera=indices_frame_camera,
            observations=observations,
            object_spacing=args.object_spacing, device=device)
        intr = np.asarray(intr, float).copy()
        ext = np.asarray(ext, float).copy()
        frames = np.asarray(frames, float).copy()
        base = dict(
            intrinsics=intr, extrinsics_rt_fromref=ext,
            frames_rt_toref=frames,
            observations_board=observations.astype(float),
            indices_frame_camintrinsics_camextrinsics=indices,
            lensmodel="LENSMODEL_STEREOGRAPHIC",
            imagersizes=imagersizes,
            calibration_object_spacing=args.object_spacing,
            do_optimize_calobject_warp=False,
            do_apply_outlier_rejection=False,
            do_apply_regularization=False)
        stage("geometry only", **dict(
            base, do_optimize_intrinsics_core=False,
            do_optimize_intrinsics_distortions=False))
        stage("geometry and LENSMODEL_STEREOGRAPHIC core", **dict(
            base, do_optimize_intrinsics_core=True,
            do_optimize_intrinsics_distortions=False))
        if re.match("LENSMODEL_SPLINED_STEREOGRAPHIC_", args.lensmodel):
            # splined models keep nominal cxy (image center) and a single
            # fxy: the spline surface absorbs everything else.  Reset and
            # reoptimize the geometry with fxycxy locked (reference :461)
            fxy = np.mean(intr[..., :2])
            intr[..., :2] = fxy
            intr[..., 2:4] = (imagersizes - 1.0) / 2.0
            stage("geometry with splined-nominal fxycxy locked", **dict(
                base, do_optimize_intrinsics_core=False,
                do_optimize_intrinsics_distortions=False))
        return intr, ext, frames, "LENSMODEL_STEREOGRAPHIC"

    # --seed: intrinsics + extrinsics from the given models; frame poses
    # from monocular PnP + joint averaging (reference :494-585)
    lensmodel = seedmodels[0].intrinsics()[0]
    if any(m.intrinsics()[0] != lensmodel for m in seedmodels):
        raise SystemExit("--seed models must share one lensmodel")
    intr = np.array([m.intrinsics()[1] for m in seedmodels])
    Rt_r0 = np.asarray(seedmodels[0].Rt_ref_cam())
    Rt_cam_ref = np.array(
        [host(mrcal.compose_Rt(m.Rt_cam_ref(), Rt_r0, device=device))
         for m in seedmodels[1:]]).reshape(-1, 4, 3)
    poses_local = mrcal.estimate_monocular_calobject_poses_Rt_tocam(
        indices_frame_camera, observations, args.object_spacing,
        seedmodels, device=device)
    frames = mrcal.estimate_joint_frame_poses(
        poses_local, Rt_cam_ref, indices_frame_camera,
        args.object_width_n, args.object_height_n or args.object_width_n,
        args.object_spacing, device=device)
    ext = np.array([host(mrcal.rt_from_Rt(Rt, device=device))
                    for Rt in Rt_cam_ref]).reshape(-1, 6)
    return intr, ext, np.asarray(frames, float).copy(), lensmodel


def main(argv=None, *, device=None):
    """The tool on `argv` (sys.argv[1:] by default), on `device` (the
    card unless "cpu").  Returns dict(stats, optimization_inputs, models)
    of the final solve."""
    args = parse_args(argv)
    device = resolve_device(device)
    import mrcal_tpu_torch as mrcal

    H = args.object_height_n or args.object_width_n
    W = args.object_width_n

    observations, indices_frame_camera, paths = \
        mrcal.compute_chessboard_corners(
            W, H, globs_per_camera=args.globs,
            corners_cache_vnl=args.corners_cache, device=device)
    if len(observations) == 0:
        print("No usable observations found", file=sys.stderr)
        sys.exit(1)
    Ncameras = len(args.globs)

    seedmodels = None
    if args.seed:
        seedmodels = [mrcal.cameramodel(f) for f in args.seed.split(",")]
        if len(seedmodels) != Ncameras:
            sys.exit(f"--seed gave {len(seedmodels)} models for "
                     f"{Ncameras} cameras")
        imagersizes = np.array([m.imagersize() for m in seedmodels])
    elif args.imagersize is not None:
        imagersizes = np.tile(args.imagersize, (Ncameras, 1))
    else:
        sys.exit("need --imagersize (or --seed models that carry it)")

    print(f"## seeding from {len(observations)} observations, "
          f"{Ncameras} cameras")
    intr_seed, ext, frames, seed_lensmodel = solve_initial(
        args, observations, indices_frame_camera, imagersizes, seedmodels,
        device)

    if seed_lensmodel != args.lensmodel:
        intrinsics = expand_intrinsics(args.lensmodel, intr_seed,
                                       np.random.default_rng(0))
    else:
        intrinsics = intr_seed

    splined = bool(re.match("LENSMODEL_SPLINED_STEREOGRAPHIC_",
                            args.lensmodel))
    oi = dict(
        intrinsics=intrinsics,
        extrinsics_rt_fromref=ext,
        frames_rt_toref=frames,
        observations_board=observations.astype(float),
        indices_frame_camintrinsics_camextrinsics=_indices(
            indices_frame_camera),
        lensmodel=args.lensmodel,
        imagersizes=imagersizes,
        calobject_warp=None,
        calibration_object_spacing=args.object_spacing,
        # splined models: the core is redundant with the spline surface
        do_optimize_intrinsics_core=(not splined
                                     and not args.skip_intrinsics_solve),
        do_optimize_intrinsics_distortions=not args.skip_intrinsics_solve,
        do_optimize_extrinsics=not args.skip_extrinsics_solve,
        do_optimize_frames=True,
        do_optimize_calobject_warp=False,
        do_apply_regularization=True,
        do_apply_outlier_rejection=not args.skip_outlier_rejection,
        verbose=args.verbose,
    )

    print("## optimizing everything except board warp from seeded "
          "intrinsics")
    mrcal.optimize(device=device, **oi)

    print("## final, full optimization")
    if not args.skip_calobject_warp_solve:
        oi["calobject_warp"] = np.zeros(2)
        oi["do_optimize_calobject_warp"] = True
    if args.skip_regularization:
        # do everything else first WITH regularization so the
        # regularization-free solution doesn't wander (reference :817-825)
        stats = mrcal.optimize(device=device, **oi)
        oi["do_apply_regularization"] = False
    stats = mrcal.optimize(device=device, **oi)

    Npts = W * H * len(observations)
    rms = stats["rms_reproj_error__pixels"]
    res = np.asarray(stats["x"][:Npts * 2]).reshape(-1, 2)
    worst = float(np.sqrt(np.max(np.sum(res * res, axis=-1))))
    print(f"RMS reprojection error: {rms:.2f} pixels")
    print(f"Worst residual (by measurement): {worst:.2f} pixels")
    if not args.skip_outlier_rejection:
        print("Noutliers: {} out of {} total points: {:.1f}% of the data"
              .format(stats["Noutliers_board"], Npts,
                      100.0 * stats["Noutliers_board"] / Npts))
    if oi.get("calobject_warp") is not None:
        print(f"calobject_warp = {oi['calobject_warp']}")

    # observations that are mostly outliers (reference markOutliers
    # semantics: <3 inlier points cannot constrain the board pose)
    w = observations[..., 2].reshape(len(observations), -1)
    n_inlier = np.sum(w > 0, axis=-1)
    for i in np.nonzero(n_inlier < 3)[0]:
        path = paths[i] if paths is not None and i < len(paths) else "?"
        print(f"Observation {i} ('{path}') is mostly outliers; consider "
              "dropping it")

    models = []
    for icam in range(Ncameras):
        m = mrcal.cameramodel(optimization_inputs=oi, icam_intrinsics=icam)
        if icam > 0 and len(np.asarray(oi["extrinsics_rt_fromref"])):
            m.extrinsics_rt_fromref(oi["extrinsics_rt_fromref"][icam - 1])
        if args.valid_intrinsics_region:
            from ..calibration import _compute_valid_intrinsics_region
            try:
                m.valid_intrinsics_region(
                    _compute_valid_intrinsics_region(m, device=device))
            except Exception as e:
                print(f"## WARNING: valid-intrinsics region failed: {e}")
        fname = f"{args.outdir}/{args.out_prefix}-{icam}.cameramodel"
        m.write(fname, note=f"generated by mrcal_tpu_torch calibrate; "
                f"rms={rms:.3f}px")
        print(f"Wrote {fname}")
        models.append(m)
    if args.explore:
        explore(models, oi, stats, paths, device)
    return dict(stats=stats, optimization_inputs=oi, models=models)


def explore_namespace(models, optimization_inputs, stats, paths, device):
    """The names of the --explore shell: models, optimization_inputs,
    stats, paths, np, mrcal, and the show_* plots of the solve, each on
    `device` (per camera, titled by it, where the plot is of one
    model)."""
    import mrcal_tpu_torch as mrcal

    def per_camera(f, icam=None, **kwargs):
        for i in ((icam,) if icam is not None else range(len(models))):
            f(models[i], title=f"{f.__name__} camera {i}", device=device,
              **kwargs)

    def of_solve(f, *args, **kwargs):
        return f(optimization_inputs, *args, device=device, **kwargs)

    return dict(
        np=np, mrcal=mrcal, models=models,
        optimization_inputs=optimization_inputs, stats=stats, paths=paths,
        show_geometry=lambda **kw: mrcal.show_geometry(models, device=device,
                                                       **kw),
        show_projection_uncertainty=lambda icam=None, **kw: per_camera(
            mrcal.show_projection_uncertainty, icam, **kw),
        show_distortion_off_pinhole=lambda icam=None, **kw: per_camera(
            mrcal.show_distortion_off_pinhole, icam, **kw),
        show_valid_intrinsics_region=lambda icam=None, **kw: per_camera(
            mrcal.show_valid_intrinsics_region, icam, **kw),
        show_residuals_vectorfield=lambda **kw: of_solve(
            mrcal.show_residuals_vectorfield, **kw),
        show_residuals_magnitudes=lambda **kw: of_solve(
            mrcal.show_residuals_magnitudes, **kw),
        show_residuals_directions=lambda **kw: of_solve(
            mrcal.show_residuals_directions, **kw),
        show_residuals_histogram=lambda **kw: of_solve(
            mrcal.show_residuals_histogram, **kw),
        show_residuals_regional=lambda **kw: of_solve(
            mrcal.show_residuals_regional, **kw),
        show_residuals_board_observation=lambda i, **kw: of_solve(
            mrcal.show_residuals_board_observation, i, **kw),
        show_residuals_board_observation_worst=lambda i, **kw: of_solve(
            mrcal.show_residuals_board_observation, i, from_worst=True,
            **kw),
    )


def explore(models, optimization_inputs, stats, paths, device):
    """The interactive shell of --explore, on explore_namespace()."""
    ns = explore_namespace(models, optimization_inputs, stats, paths,
                           device)
    banner = ("\n== mrcal explore shell ==\n"
              "in scope: models, optimization_inputs, stats, paths, and\n"
              "  " + ", ".join(k for k in ns
                               if k.startswith("show_")) + "\n")
    try:
        import IPython
        IPython.embed(banner1=banner, user_ns=ns)
    except ImportError:
        import code
        code.interact(banner=banner, local=ns)


if __name__ == "__main__":
    main()
