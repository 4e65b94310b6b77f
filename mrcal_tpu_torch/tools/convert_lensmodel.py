"""Convert a camera model to a different lens model.

The port of tools/mrcal-convert-lensmodel (reference:
mrcal-convert-lensmodel).  Two modes, like the reference:
 - default: re-solve the ORIGINAL calibration problem (from the embedded
   optimization_inputs) under the new lens model; --monocular restricts
   the re-solve to the one requested camera's observations
 - --sampled: fit the new model to a dense grid of synthetic point
   observations of the current model (no optimization_inputs needed).
   --where/--radius select the fit domain on the imager
   (reference mrcal-convert-lensmodel:88-105); --distance takes a
   comma-separated list (a near AND a far distance constrain the
   extrinsics, reference :63-76); --num-trials re-runs the sampled solve
   from random seeds and keeps the best (reference :79-82).
--viz draws the projection difference between the old and the new model
(mrcal_tpu_torch.show_projection_diff).  The solves and the difference
run on the CUDA card (device="cpu" from Python runs them on the CPU).

    python -m mrcal_tpu_torch.tools.convert_lensmodel \\
        --outfile camera-0-opencv4.cameramodel LENSMODEL_OPENCV4 \\
        camera-0.cameramodel
"""

import argparse
import os
import sys

import numpy as np

from .._config import resolve_device
from ._common import host


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mrcal_tpu_torch.tools.convert_lensmodel",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--sampled", action="store_true")
    p.add_argument("--distance", type=str, default="10.0",
                   help="--sampled: comma-separated range(s) of the fitted "
                        "grid points; pass a near AND a far distance to "
                        "constrain the extrinsics (e.g. '1.5,1000')")
    p.add_argument("--gridn", type=int, nargs=2, default=[30, 20])
    p.add_argument("--where", type=str, default=None,
                   help="--sampled: center (X,Y px) of the fit region; "
                        "default: imager center")
    p.add_argument("--radius", type=float, default=0.0,
                   help="--sampled: fit-region radius in px around --where. "
                        "0: use ALL the data; <0: margin rule "
                        "r = sqrt(W^2+H^2)/2 - |radius|")
    p.add_argument("--num-trials", type=int, default=1,
                   help="--sampled: re-run the fit from this many random "
                        "seeds, keep the lowest-rms solution")
    p.add_argument("--monocular", action="store_true",
                   help="re-solve mode: re-solve only the observations of "
                        "the requested camera")
    p.add_argument("--intrinsics-only", action="store_true",
                   help="re-solve mode: keep geometry fixed")
    p.add_argument("--all", action="store_true",
                   help="used if not --sampled: write the converted model of "
                        "EVERY camera in the original solve, not just this "
                        "one (exclusive with --monocular).  Output files are "
                        "named <model>-<icam>-<lensmodel_to>.cameramodel")
    p.add_argument("--viz", action="store_true",
                   help="show a projection-diff plot of old vs new model")
    p.add_argument("--cbmax", type=float, default=4.0,
                   help="--viz colorbar maximum")
    p.add_argument("--title", default=None, help="--viz plot title")
    p.add_argument("--hardcopy", default=None,
                   help="write the --viz plot to this file")
    p.add_argument("--force", "-f", action="store_true",
                   help="overwrite existing output files")
    p.add_argument("--outdir", default=None,
                   help="directory for the output model(s); default: "
                        "alongside the input (or stdout for '-' outfile)")
    p.add_argument("--outfile", default="-")
    p.add_argument("lensmodel_to")
    p.add_argument("model")
    return p.parse_args(argv)


def convert_sampled(a, m, intr_to0, device):
    """The --sampled fit: the new intrinsics fitted to the current model's
    unprojections of a grid, as a solve of fixed points.  Returns
    (rms, optimization_inputs, Ngrid, Ndistances)."""
    import mrcal_tpu_torch as mrcal
    lensmodel_from, intr_from = m.intrinsics()
    W, H = m.imagersize()
    n_to = len(intr_to0)
    distances = [float(d) for d in a.distance.split(",")]
    if a.where is not None:
        cx, cy = (float(v) for v in a.where.split(","))
    else:
        cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    if a.radius == 0.0:
        radius = None                       # all data
    elif a.radius < 0:
        radius = np.sqrt(W * W + H * H) / 2.0 - abs(a.radius)
    else:
        radius = a.radius

    # sample the imager, unproject through the current model, fit the new
    # intrinsics as a point-observation-only solve with fixed points
    v, q = mrcal.sample_imager_unproject(a.gridn[0], a.gridn[1], W, H,
                                         lensmodel_from, intr_from,
                                         normalize=True, device=device)
    v = host(v).reshape(-1, 3)
    q = host(q).reshape(-1, 2)
    keep = np.all(np.isfinite(v), axis=-1)
    if radius is not None:
        keep &= np.linalg.norm(q - np.array([cx, cy]), axis=-1) <= radius
    v = v[keep]
    q = q[keep]
    if len(q) < 8:
        print(f"Only {len(q)} grid points inside the fit region; "
              "enlarge --radius", file=sys.stderr)
        sys.exit(1)
    points = np.concatenate([v * d for d in distances], axis=0)
    qd = np.tile(q, (len(distances), 1))
    obs = np.concatenate([qd, np.ones((len(qd), 1))], axis=-1)
    idx = np.stack([np.arange(len(qd)), np.zeros(len(qd)),
                    -np.ones(len(qd))], axis=-1).astype(np.int32)

    def fit(seed):
        rng = np.random.default_rng(seed)
        intr0 = intr_to0.copy()
        if seed:
            intr0[:2] *= 1 + rng.normal(0, 0.02, 2)
            intr0[4:] += rng.normal(0, 1e-3, max(n_to - 4, 0))
        oi = dict(intrinsics=intr0[None].copy(),
                  points=points.copy(),
                  observations_point=obs.copy(),
                  indices_point_camintrinsics_camextrinsics=idx,
                  lensmodel=a.lensmodel_to,
                  imagersizes=np.array([[W, H]]),
                  Npoints_fixed=len(points),
                  do_optimize_extrinsics=False,
                  do_optimize_frames=False,
                  do_apply_outlier_rejection=False,
                  do_apply_regularization=True)
        if a.lensmodel_to.startswith("LENSMODEL_SPLINED"):
            oi["do_optimize_intrinsics_core"] = False
        stats = mrcal.optimize(device=device, **oi)
        return stats["rms_reproj_error__pixels"], oi

    rms, oi = min((fit(s) for s in range(max(a.num_trials, 1))),
                  key=lambda t: t[0])
    return rms, oi, len(q), len(distances)


def convert_resolve(a, m, intr_to0, device):
    """The re-solve of the model's calibration under the new lens model
    (--monocular: only this camera's observations; --intrinsics-only: the
    geometry fixed).  Returns (stats, optimization_inputs, icam)."""
    import mrcal_tpu_torch as mrcal
    oi = m.optimization_inputs()
    icam = m.icam_intrinsics()
    Ncam = np.asarray(oi["intrinsics"]).shape[0]
    if a.monocular and Ncam > 1:
        # keep only this camera's board observations; single-camera solve
        idxf = np.asarray(
            oi["indices_frame_camintrinsics_camextrinsics"])
        sel = idxf[:, 1] == icam
        frames_used = np.unique(idxf[sel, 0])
        remap_f = -np.ones(int(idxf[:, 0].max()) + 1, dtype=np.int32)
        remap_f[frames_used] = np.arange(len(frames_used))
        oi["observations_board"] = \
            np.asarray(oi["observations_board"])[sel]
        oi["indices_frame_camintrinsics_camextrinsics"] = np.stack(
            [remap_f[idxf[sel, 0]],
             np.zeros(sel.sum(), np.int32),
             -np.ones(sel.sum(), np.int32)], axis=-1).astype(np.int32)
        oi["frames_rt_toref"] = \
            np.asarray(oi["frames_rt_toref"])[frames_used].copy()
        oi["intrinsics"] = np.asarray(oi["intrinsics"])[[icam]].copy()
        oi["imagersizes"] = np.asarray(oi["imagersizes"])[[icam]].copy()
        oi["extrinsics_rt_fromref"] = np.zeros((0, 6))
        icam = 0
    oi["lensmodel"] = a.lensmodel_to
    Ncam_now = np.asarray(oi["intrinsics"]).shape[0]
    oi["intrinsics"] = np.tile(intr_to0, (Ncam_now, 1))
    if a.lensmodel_to.startswith("LENSMODEL_SPLINED"):
        oi["do_optimize_intrinsics_core"] = False
    if a.intrinsics_only:
        oi["do_optimize_extrinsics"] = False
        oi["do_optimize_frames"] = False
        oi["do_optimize_calobject_warp"] = False
    stats = mrcal.optimize(device=device, **oi)
    return stats, oi, icam


def main(argv=None, *, device=None):
    """The tool on `argv`, on `device` (the card unless "cpu").  Returns
    dict(model, optimization_inputs, rms) of the conversion."""
    a = parse_args(argv)
    device = resolve_device(device)
    import mrcal_tpu_torch as mrcal

    m = mrcal.cameramodel(a.model)
    intr_from = m.intrinsics()[1]
    W, H = m.imagersize()
    n_to = mrcal.lensmodel_num_params(a.lensmodel_to)

    # seed: same core, zero distortions
    intr_to0 = np.concatenate([np.asarray(intr_from[:4]),
                               np.zeros(n_to - 4)])

    if a.sampled or m.optimization_inputs() is None:
        rms, oi, Ngrid, Ndist = convert_sampled(a, m, intr_to0, device)
        print(f"## sampled fit rms: {rms:.4f} px "
              f"({Ngrid} grid points x {Ndist} distance(s))",
              file=sys.stderr)
        m_out = mrcal.cameramodel(
            intrinsics=(a.lensmodel_to, oi["intrinsics"][0]),
            imagersize=(W, H), rt_cam_ref=m.extrinsics_rt_fromref())
    else:
        if a.where is not None or a.radius != 0.0:
            print("--where/--radius apply only to --sampled fits "
                  "(the re-solve uses the original observations)",
                  file=sys.stderr)
            sys.exit(1)
        stats, oi, icam = convert_resolve(a, m, intr_to0, device)
        rms = stats["rms_reproj_error__pixels"]
        print(f"## re-solve rms: {rms:.4f} px", file=sys.stderr)
        m_out = mrcal.cameramodel(optimization_inputs=oi,
                                  icam_intrinsics=icam)
        m_out.extrinsics_rt_fromref(m.extrinsics_rt_fromref())

    if a.viz:
        mrcal.show_projection_diff((m, m_out), distance=None, cbmax=a.cbmax,
                                   title=a.title, hardcopy=a.hardcopy,
                                   device=device)

    def write_model(model, path):
        if path == "-":
            model.write(sys.stdout)
            return
        if a.outdir is not None:
            path = os.path.join(a.outdir, os.path.basename(path))
        if os.path.exists(path) and not a.force:
            print(f"'{path}' already exists. Not overwriting; pass --force "
                  "to overwrite", file=sys.stderr)
            sys.exit(1)
        model.write(path)
        print(f"Wrote {path}", file=sys.stderr)

    if a.all and (a.sampled or a.monocular
                  or m.optimization_inputs() is None):
        print("--all requires the full re-solve mode: a model with embedded "
              "optimization_inputs and neither --sampled nor --monocular",
              file=sys.stderr)
        sys.exit(1)
    if a.all:
        # every camera of the (re-solved) joint problem
        base = (os.path.splitext(a.model)[0] if a.model != "-"
                else "camera")
        Ncam_out = np.asarray(oi["intrinsics"]).shape[0]
        for ic in range(Ncam_out):
            m_ic = mrcal.cameramodel(optimization_inputs=oi,
                                     icam_intrinsics=ic)
            write_model(m_ic, f"{base}-{ic}-{a.lensmodel_to}.cameramodel")
    else:
        write_model(m_out, a.outfile)
    return dict(model=m_out, optimization_inputs=oi, rms=rms)


if __name__ == "__main__":
    main()
