"""Triangulate a feature observed in two images and report the 3D position
with uncertainties and a full sensitivity analysis.

The port of tools/mrcal-triangulate (reference: mrcal-triangulate).
Reports: triangulated point (camera + reference coords), range (+ error
vs --range-estimate), reprojection residual, calibration/observation
uncertainty ellipsoids, and empirical sensitivities of the range to pixel
noise, calibration yaw/pitch, and baseline translation — with linearized
corrections that would explain an observed range error.  The projections,
the triangulation and its uncertainty run on the CUDA card (device="cpu"
from Python runs them on the CPU); the optimized corrections are scipy's
on the host; --viz uncertainty draws the uncertainty ellipses with
matplotlib.

    python -m mrcal_tpu_torch.tools.triangulate \\
        --q-calibration-stdev 0.3 --q-observation-stdev 0.3 \\
        camera-0.cameramodel camera-1.cameramodel 400 300 371.2 301.5
"""

import argparse
import sys

import numpy as np
import torch

from .._config import resolve_device
from ._common import host


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mrcal_tpu_torch.tools.triangulate",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--method", default="leecivera_mid2",
                   choices=["geometric", "leecivera_l1", "leecivera_linf",
                            "leecivera_mid2", "leecivera_wmid2"])
    p.add_argument("--range-estimate", type=float, default=None,
                   help="known approximate range; enables range-error "
                        "reports and corrections")
    p.add_argument("--q-calibration-stdev", type=float, default=None)
    p.add_argument("--q-observation-stdev", type=float, default=None)
    p.add_argument("--q-observation-stdev-correlation", type=float,
                   default=0.0)
    p.add_argument("--stabilize-coords", "--stabilize",
                   action="store_true")
    p.add_argument("--template-size", type=int, default=13,
                   help="feature-matching template size (with images)")
    p.add_argument("--search-radius", type=int, default=20)
    p.add_argument("--corr-floor", type=float, default=0.9,
                   help="minimum acceptable feature-match correlation")
    p.add_argument("--plane-n", type=float, nargs=3, default=None,
                   help="normal of a observed plane (camera-0 coords); "
                        "with --plane-d, builds the feature-matching "
                        "homography from the plane instead of the "
                        "constant-disparity guess")
    p.add_argument("--plane-d", type=float, default=None)
    p.add_argument("--clahe", action="store_true",
                   help="apply adaptive histogram equalization to the "
                        "images before template matching")
    p.add_argument("--title", default=None,
                   help="--viz plot title (replaces the default)")
    p.add_argument("--extratitle", default=None,
                   help="text appended to the default --viz plot title")
    p.add_argument("--viz", choices=["uncertainty"], default=None,
                   help="write an uncertainty-ellipse plot "
                        "(triangulate-uncertainty.png)")
    p.add_argument("--hardcopy", default=None,
                   help="--viz output filename")
    p.add_argument("--make-corrected-model1", action="store_true",
                   help="write a yaw/pitch-corrected camera-1 model to "
                        "standard output (needs --range-estimate)")
    p.add_argument("models", nargs=2)
    p.add_argument("rest", nargs="+",
                   help="either 'x0 y0 x1 y1' (pixel observations in the "
                        "two cameras), or 'x0 y0 image0 image1' (find the "
                        "camera-1 match by template search)")
    return p.parse_args(argv)


def match(models, q0, im0, im1, a, device):
    """The camera-1 pixel of camera 0's feature q0, found by template
    matching the 8-bit images (arrays) im0 and im1 from the homography
    guess at --range-estimate (or through --plane-n/--plane-d)."""
    import mrcal_tpu_torch as mrcal
    if a.clahe:
        from ..image import clahe_equalize
        im0 = clahe_equalize(np.asarray(im0))
        im1 = clahe_equalize(np.asarray(im1))
    if a.range_estimate is None:
        sys.exit("feature matching needs --range-estimate for the "
                 "initial homography guess")
    v0 = mrcal.unproject(q0, *models[0].intrinsics(), normalize=True,
                         device=device)
    p_guess = v0 * a.range_estimate
    Rt10 = host(mrcal.compose_Rt(models[1].Rt_cam_ref(),
                                 models[0].Rt_ref_cam(), device=device))
    p1 = mrcal.transform_point_Rt(Rt10, p_guess, device=device)
    q1_perfect = host(mrcal.project(p1, *models[1].intrinsics(),
                                    device=device))
    print(f"## Feature {q0} in the left image corresponds to "
          f"{q1_perfect} at {a.range_estimate}m")
    if a.plane_n is not None and a.plane_d is not None:
        # homography through the observed plane (reference
        # mrcal-triangulate:293 compute_H10_planes): for a plane
        # n.p = d in cam0 coords, p1 = (R10 + t10 n^T / d) p0
        n = np.asarray(a.plane_n, np.float64)
        i0, i1 = models[0].intrinsics()[1], models[1].intrinsics()[1]
        K0 = np.array([[i0[0], 0, i0[2]], [0, i0[1], i0[3]], [0, 0, 1.0]])
        K1 = np.array([[i1[0], 0, i1[2]], [0, i1[1], i1[3]], [0, 0, 1.0]])
        Hmetric = Rt10[:3, :] + np.outer(Rt10[3, :], n) / a.plane_d
        H10 = K1 @ Hmetric @ np.linalg.inv(K0)
        H10 /= H10[2, 2]
    else:
        H10 = np.eye(3)
        H10[:2, 2] = q1_perfect - q0
    q1, diag = mrcal.match_feature(
        im0, im1, q0, H10=H10,
        search_radius1=a.search_radius,
        template_size1=a.template_size, device=device)
    if q1 is None or diag.get("score", 1.0) < a.corr_floor:
        sys.exit("## Feature-matching failed! Maybe increase the "
                 "--search-radius or reduce --corr-floor?")
    q1 = np.asarray(q1)
    print(f"## Feature match found at {q1}")
    print(f"## q1 - q1_perfect_at_range = {q1 - q1_perfect}")
    return q1


def report(models, q0, q1, a, device):
    """mrcal-triangulate's report of the feature q0 in camera 0 and q1 in
    camera 1 (pixels), printed; returns its numbers in a dict (numpy)."""
    import mrcal_tpu_torch as mrcal
    method = getattr(mrcal, f"triangulate_{a.method}")
    out = {}

    v0 = mrcal.unproject(q0, *models[0].intrinsics(), device=device)
    Rt01 = host(mrcal.compose_Rt(models[0].Rt_cam_ref(),
                                 models[1].Rt_ref_cam(), device=device))
    t01 = Rt01[3, :]

    tri = mrcal.triangulate(
        np.stack([q0, q1]), models, method=method,
        q_calibration_stdev=a.q_calibration_stdev,
        q_observation_stdev=a.q_observation_stdev,
        q_observation_stdev_correlation=a.q_observation_stdev_correlation,
        stabilize_coords=a.stabilize_coords, device=device)
    Var_cal = Var_obs = None
    if a.q_calibration_stdev is not None and \
            a.q_observation_stdev is not None:
        p0, Var_cal, Var_obs, _ = tri
    elif a.q_calibration_stdev is not None:
        p0, Var_cal = tri
    elif a.q_observation_stdev is not None:
        p0, Var_obs = tri
    else:
        p0 = tri
    p0 = host(p0)

    if np.dot(p0, p0) == 0:
        sys.exit("Observation rays divergent: feature is near infinity "
                 "or a false match was found")

    p0_ref = host(mrcal.transform_point_Rt(models[0].Rt_ref_cam(), p0,
                                           device=device))
    range0 = float(np.linalg.norm(p0))
    out.update(p0=p0, p0_ref=p0_ref, range=range0)
    print(f"## Triangulated point at {p0}; "
          f"direction: {p0 / range0} [camera coordinates]")
    print(f"## Triangulated point at {p0_ref} [reference coordinates]")
    if a.range_estimate is not None:
        range_err = range0 - a.range_estimate
        print(f"## Range: {range0:.2f} m (error: {range_err:.2f} m)")
    else:
        range_err = None
        print(f"## Range: {range0:.2f} m")
    qfit = host(mrcal.project(p0, *models[0].intrinsics(), device=device))
    out["q0_residual"] = q0 - qfit
    print(f"## q0 - q0_triangulation = {q0 - qfit}")

    for what, V in (("calibration-time", Var_cal),
                    ("observation-time", Var_obs)):
        if V is None:
            continue
        l, v = np.linalg.eigh(host(V))
        sigma = np.sqrt(max(l[-1], 0))
        out[f"{what} sigma"] = sigma
        out[f"{what} direction"] = v[:, -1]
        print(f"## Uncertainty propagation: {what} noise suggests worst "
              f"confidence of sigma={sigma:.3f}m along {v[:, -1]}")

    # ---------------- empirical sensitivities ----------------
    # worst-case yaw axis = normal of the epipolar plane
    n_epi = np.cross(p0, t01)
    n_epi /= np.linalg.norm(n_epi)
    if n_epi[1] < 0:
        n_epi *= -1.0
    v_pitch = t01 / np.linalg.norm(t01)

    def axis_angle_R(axis, angle):
        K = host(mrcal.skew_symmetric(torch.as_tensor(axis)))
        return np.eye(3) + np.sin(angle) * K + \
            (1.0 - np.cos(angle)) * K @ K

    # camera 1's ray of q1, and the rays of its perturbations, unprojected
    # once; each perturbation of a kind is one batched call
    v1l_q1 = mrcal.unproject(q1, *models[1].intrinsics(), device=device)

    def p_perturbed(qerr1=None, t01err=(0., 0., 0.),
                    yaw=0.0, yaw_axis=None, pitch=0.0):
        R = np.eye(3)
        if yaw:
            R = axis_angle_R(yaw_axis, yaw)
        if pitch:
            R = R @ axis_angle_R(v_pitch, pitch)
        v1l = v1l_q1 if qerr1 is None else mrcal.unproject(
            q1 + np.asarray(qerr1), *models[1].intrinsics(), device=device)
        v1 = mrcal.rotate_point_R(R @ Rt01[:3, :], v1l, device=device)
        return host(method(v0, v1, t01 + np.asarray(t01err),
                           device=device))

    def rng(**kw):
        return np.linalg.norm(p_perturbed(**kw), axis=-1)

    def first_worst(directions, ranges):
        worst, v_worst = 0.0, None
        for v, r in zip(directions, ranges):
            if r == 0:
                sys.exit("Sampled rays divergent")
            if abs(r - range0) > worst:
                worst, v_worst = abs(r - range0), v
        return worst, v_worst

    delta = 1e-3
    vqs = np.array([[np.cos(th), np.sin(th)]
                    for th in np.linspace(0, 2 * np.pi, 90, endpoint=False)])
    worst, vq_worst = first_worst(vqs, rng(qerr1=delta * vqs))
    out.update(q_sensitivity=worst / delta, q_worst_direction=vq_worst)
    msg = (f"## Observed-pixel range sensitivity: {worst / delta:.3f}m/px"
           f" (q1). Worst direction: {vq_worst}.")
    if range_err is not None and worst > 0:
        msg += (" Linearized correction: "
                f"{-range_err / worst * delta:.3f} pixels")
    print(msg)

    dd = delta * np.pi / 180.0
    for key, label, kw in (
            ("yaw_epipolar_sensitivity",
             "Calibration yaw (rotation in epipolar plane)",
             dict(yaw=dd, yaw_axis=n_epi)),
            ("yaw_y_sensitivity",
             "Calibration yaw (cam0 y axis)               ",
             dict(yaw=dd, yaw_axis=np.array([0., 1., 0.]))),
    ):
        r = float(rng(**kw))
        if r == 0:
            sys.exit("Sampled rays divergent")
        err = (r - range0) / delta
        out[key] = err
        msg = f"## {label} sensitivity: {err:.2f}m/deg."
        if range_err is not None and err != 0:
            msg += (" Linearized correction: "
                    f"{-range_err / err:.3f} degrees of yaw")
        print(msg)
    r = float(rng(pitch=dd))
    out["pitch_sensitivity"] = (r - range0) / delta
    print("## Calibration pitch (tilt of epipolar plane) sensitivity: "
          f"{(r - range0) / delta:.2f}m/deg.")

    vts = np.array([[np.cos(ph) * np.sin(th), np.cos(ph) * np.cos(th),
                     np.sin(ph)]
                    for th in np.linspace(0, 2 * np.pi, 40, endpoint=False)
                    for ph in np.linspace(0, np.pi, 20)])
    worst, vt_worst = first_worst(vts, rng(t01err=delta * vts))
    out.update(t_sensitivity=worst / delta, t_worst_direction=vt_worst)
    msg = (f"## Calibration translation sensitivity: {worst / delta:.2f}m/m."
           f" Worst direction: {vt_worst}.")
    if range_err is not None and worst > 0:
        msg += (" Linearized correction: "
                f"{-range_err / worst * delta:.2f} meters of translation")
    print(msg)

    # optimized yaw/pitch corrections explaining the observed range error
    if a.range_estimate is not None:
        import scipy.optimize

        def err_sq(x):
            dy, dp = x
            p = p_perturbed(yaw=dy, yaw_axis=n_epi, pitch=dp)
            r = np.linalg.norm(p)
            if r == 0:
                return 1e6
            er = r - a.range_estimate
            eq = host(mrcal.project(p, *models[0].intrinsics(),
                                    device=device)) - q0
            return er * er + 1e4 * float(np.dot(eq, eq))

        res = scipy.optimize.minimize(err_sq, (0.0, 0.0))
        dyaw, dpitch = res.x
        print("## Optimized yaw   (rotation in epipolar plane) correction"
              f" = {np.degrees(dyaw):.3f} degrees")
        print("## Optimized pitch (tilt of epipolar plane)     correction"
              f" = {np.degrees(dpitch):.3f} degrees")
        # the corrected full relative orientation, reported as rt10 yaw
        # (reference mrcal-triangulate:908)
        R = axis_angle_R(n_epi, dyaw) @ axis_angle_R(v_pitch, dpitch)
        Rt01c = Rt01.copy()
        Rt01c[:3, :] = R @ Rt01[:3, :]
        rt10c = host(mrcal.rt_from_Rt(mrcal.invert_Rt(Rt01c, device=device),
                                      device=device))
        print("## Optimized relative yaw (1 <- 0): "
              f"{np.degrees(rt10c[1]):.3f} degrees")
        out.update(dyaw=dyaw, dpitch=dpitch, rt10_corrected=rt10c)

    if a.viz == "uncertainty":
        draw_uncertainty(a, None if Var_cal is None else host(Var_cal),
                         None if Var_obs is None else host(Var_obs), range0)
    return out


def draw_uncertainty(a, Var_cal, Var_obs, range0):
    """--viz uncertainty: the calibration-time and observation-time 1-sigma
    ellipses of the point (its covariances projected onto the plane of
    their two largest axes), written to --hardcopy
    (triangulate-uncertainty.png by default); without a covariance, a
    warning and no file."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(6, 5))
    drew = False
    for what, V, color in (("calibration", Var_cal, "C0"),
                           ("observation", Var_obs, "C1")):
        if V is None:
            continue
        l, vecs = np.linalg.eigh(V)
        th = np.linspace(0, 2 * np.pi, 200)
        circ = np.stack([np.cos(th), np.sin(th)])
        e2 = vecs[:, -2:] @ (np.sqrt(np.maximum(l[-2:], 0))[:, None] * circ)
        ax.plot(e2[0], e2[1], color=color, label=f"{what}-time 1-sigma")
        drew = True
    if drew:
        title = a.title or f"Triangulation uncertainty at {range0:.1f} m"
        if a.extratitle:
            title += f": {a.extratitle}"
        ax.set_title(title)
        ax.set_xlabel("m")
        ax.set_ylabel("m")
        ax.legend()
        ax.set_aspect("equal")
        out = a.hardcopy or "triangulate-uncertainty.png"
        fig.savefig(out, dpi=120)
        print(f"## wrote {out}")
    else:
        print("## WARNING: don't have any ellipses, so not "
              "visualizing them (pass --q-calibration-stdev / "
              "--q-observation-stdev)")


def main(argv=None, *, device=None):
    """The tool on `argv`, on `device` (the card unless "cpu").  Returns
    report()'s dict."""
    a = parse_args(argv)
    device = resolve_device(device)
    import mrcal_tpu_torch as mrcal

    models = [mrcal.cameramodel(f) for f in a.models]
    if len(a.rest) != 4:
        sys.exit("need 4 trailing args: x0 y0 x1 y1  OR  x0 y0 img0 img1")
    try:
        q = np.array([float(x) for x in a.rest]).reshape(2, 2)
        q0, q1 = q[0], q[1]
    except ValueError:
        # x0 y0 image0 image1: find q1 by template matching
        q0 = np.array([float(a.rest[0]), float(a.rest[1])])
        im0 = mrcal.load_image(a.rest[2], bits_per_pixel=8, channels=1)
        im1 = mrcal.load_image(a.rest[3], bits_per_pixel=8, channels=1)
        q1 = match(models, q0, im0, im1, a, device)

    out = report(models, q0, q1, a, device)

    if a.make_corrected_model1:
        if "dyaw" not in out:
            sys.exit("--make-corrected-model1 needs --range-estimate")
        rt_1r = host(mrcal.compose_rt(
            out["rt10_corrected"], models[0].extrinsics_rt_fromref(),
            device=device))
        models[1].extrinsics_rt_fromref(rt_1r)
        models[1].write(sys.stdout)
        out["corrected_model1"] = models[1]
    return out


if __name__ == "__main__":
    main()
