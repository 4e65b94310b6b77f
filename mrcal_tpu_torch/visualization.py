"""The plots of a calibration, in PyTorch and matplotlib.

Counterpart of ``mrcal_tpu/visualization.py``: the same 15 ``show_*``
functions, with the same figures, and the three host helpers
(``annotate_image__valid_intrinsics_region``, ``fitted_gaussian_equation``,
``imagergrid_using``).

Each ``show_*`` computes the arrays its figure shows in a private
``_*_data`` function, on the device (the CUDA card unless given
``device="cpu"``), and returns them as numpy arrays; it then draws them
with matplotlib on the host.  matplotlib is imported only to draw, so
``import mrcal_tpu_torch`` loads none of it; on a machine without
matplotlib a ``show_*`` computes its data and then raises matplotlib's
``ImportError``.  Each returns the Figure (or ``(Figure, array)``), and
``hardcopy=<path>`` saves the figure there.
"""

import os

import numpy as np
import torch

from ._config import resolve_device


def _np(x):
    """A tensor anywhere, or an array, as a numpy array."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _finish(fig, hardcopy):
    if hardcopy:
        fig.savefig(hardcopy, dpi=120, bbox_inches="tight")
    return fig


def _title(default, title, extratitle):
    """`title` replaces the default, and `extratitle` is appended to
    whichever is active."""
    t = title if title is not None else default
    if extratitle:
        t = f"{t}: {extratitle}"
    return t


def _new_axes(title=None, _3d=False):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(111, projection="3d" if _3d else None)
    if title:
        ax.set_title(title)
    return fig, ax


def _extent(q):
    """imshow's extent of a (..., 2) pixel grid, y down."""
    return (q[..., 0].min(), q[..., 0].max(), q[..., 1].max(),
            q[..., 1].min())


# ----------------------------------------------------------------------------
# geometry
# ----------------------------------------------------------------------------

def _geometry_data(models_or_rt_cam_ref, *, frames_rt_toref, points,
                   icam_extrinsics_fromsolve, cameras_Rt_plot_ref,
                   show_calobjects, show_points, calobject_warp,
                   axis_scale, object_width_n, object_height_n,
                   object_spacing, device):
    """show_geometry's arrays: dict(cameras (Ncameras, 4, 3): each
    camera's origin and the tips of its x, y, z axes, boards (Nframes,
    Ny*Nx, 3) or None, points (N, 3) or None, axis_scale), all in the
    plot frame."""
    from . import poseutils
    models = list(models_or_rt_cam_ref)

    # the solve's geometry, from the first model that has it
    oi = None
    icam_oi = None
    for m in models:
        if hasattr(m, "optimization_inputs") and \
                m.optimization_inputs() is not None:
            oi = m.optimization_inputs()
            icam_oi = (m.icam_intrinsics()
                       if hasattr(m, "icam_intrinsics") else None)
            break

    if icam_extrinsics_fromsolve is not None:
        if oi is None:
            raise Exception("icam_extrinsics_fromsolve needs a model with "
                            "optimization_inputs")
        ext = np.asarray(oi.get("extrinsics_rt_fromref",
                                oi.get("rt_cam_ref")))
        if isinstance(icam_extrinsics_fromsolve, str):   # 'all'
            models = list(ext)
        else:
            models = [ext[i] for i in icam_extrinsics_fromsolve]

    rts = np.array([np.asarray(m.extrinsics_rt_fromref())
                    if hasattr(m, "extrinsics_rt_fromref")
                    else np.asarray(m).reshape(6) for m in models],
                   dtype=np.float64).reshape(-1, 6)

    if oi is not None:
        if frames_rt_toref is None and show_calobjects:
            idxb = np.asarray(
                oi.get("indices_frame_camintrinsics_camextrinsics",
                       np.zeros((0, 3))))
            frames = oi.get("frames_rt_toref", oi.get("rt_ref_frame"))
            if frames is not None and len(np.asarray(frames)):
                frames = np.asarray(frames)
                if show_calobjects == "thiscamera" and icam_oi is not None \
                        and len(idxb):
                    frames = frames[np.unique(
                        idxb[idxb[:, 1] == icam_oi][:, 0])]
                frames_rt_toref = frames
            if object_width_n is None and \
                    oi.get("observations_board") is not None and \
                    len(np.asarray(oi["observations_board"])):
                object_height_n, object_width_n = \
                    np.asarray(oi["observations_board"]).shape[1:3]
                object_spacing = oi.get("calibration_object_spacing")
                if calobject_warp is None:
                    calobject_warp = oi.get("calobject_warp")
        if points is None and show_points and \
                oi.get("points") is not None:
            points = np.asarray(oi["points"])
            if show_points == "thiscamera" and icam_oi is not None:
                idxp = np.asarray(
                    oi.get("indices_point_camintrinsics_camextrinsics",
                           np.zeros((0, 3))))
                if len(idxp):
                    points = points[np.unique(
                        idxp[idxp[:, 1] == icam_oi][:, 0])]

    Rt_ref_cam = (_np(poseutils.invert_Rt(
        poseutils.Rt_from_rt(rts, device=device), device=device))
        if len(rts) else np.zeros((0, 4, 3)))

    # the axes' length: a tenth of the scene's extent, from host arrays
    if axis_scale is None:
        origins = Rt_ref_cam[:, 3]
        extent = (np.ptp(origins, axis=0).max() if len(origins) > 1
                  else 0.0)
        if frames_rt_toref is not None and len(np.asarray(frames_rt_toref)):
            extent = max(extent, float(np.ptp(
                np.asarray(frames_rt_toref)[:, 3:], axis=0).max()))
        axis_scale = max(extent * 0.1, 0.1)

    def to_plot_frame(p):
        if cameras_Rt_plot_ref is None:
            return p
        return _np(poseutils.transform_point_Rt(
            np.asarray(cameras_Rt_plot_ref), p, device=device))

    cameras = np.concatenate(
        [Rt_ref_cam[:, 3:], Rt_ref_cam[:, 3:] + Rt_ref_cam[:, :3]
         * axis_scale], axis=1)
    if len(cameras):
        cameras = to_plot_frame(cameras)
    boards = None
    if frames_rt_toref is not None and object_width_n and show_calobjects:
        from .synthetic_data import ref_calibration_object
        board = ref_calibration_object(object_width_n, object_height_n,
                                       object_spacing,
                                       calobject_warp=calobject_warp)
        frames = np.asarray(frames_rt_toref, dtype=np.float64)
        boards = to_plot_frame(_np(poseutils.transform_point_rt(
            frames[:, None, :], np.asarray(board).reshape(1, -1, 3),
            device=device)))
    if points is not None and show_points:
        points = to_plot_frame(np.asarray(points, dtype=np.float64))
    else:
        points = None
    return dict(cameras=cameras, boards=boards, points=points,
                axis_scale=axis_scale)


def show_geometry(models_or_rt_cam_ref=None,
                  *, frames_rt_toref=None, rt_ref_frame=None, points=None,
                  icam_extrinsics_fromsolve=None,
                  cameras_Rt_plot_ref=None,
                  show_calobjects="all", show_points="all",
                  calobject_warp=None, point_labels=None,
                  cameranames=None, axis_scale=None,
                  object_width_n=None, object_height_n=None,
                  object_spacing=None,
                  title=None, extratitle=None, hardcopy=None,
                  models_or_extrinsics_rt_fromref=None, device=None,
                  **kwargs):
    """3D plot of cameras, boards and points.

    Takes cameramodels or (6,) rt_cam_ref arrays.  Without rt_ref_frame or
    points, the solve's geometry comes from the first model that holds
    optimization_inputs (show_calobjects/show_points: 'all', 'thiscamera'
    or falsy).  icam_extrinsics_fromsolve replaces the cameras by poses of
    the solve's extrinsics ('all' or an iterable of indices).
    cameras_Rt_plot_ref maps everything into a plot frame; point_labels
    maps a point's index to its label."""
    device = resolve_device(device)
    if models_or_rt_cam_ref is None:
        models_or_rt_cam_ref = models_or_extrinsics_rt_fromref
    if rt_ref_frame is not None and frames_rt_toref is None:
        frames_rt_toref = rt_ref_frame
    d = _geometry_data(
        models_or_rt_cam_ref, frames_rt_toref=frames_rt_toref,
        points=points, icam_extrinsics_fromsolve=icam_extrinsics_fromsolve,
        cameras_Rt_plot_ref=cameras_Rt_plot_ref,
        show_calobjects=show_calobjects, show_points=show_points,
        calobject_warp=calobject_warp, axis_scale=axis_scale,
        object_width_n=object_width_n, object_height_n=object_height_n,
        object_spacing=object_spacing, device=device)

    fig, ax = _new_axes(_title("Camera geometry", title, extratitle),
                        _3d=True)
    for i, cam in enumerate(d["cameras"]):
        origin = cam[0]
        for tip, color in zip(cam[1:], "rgb"):
            ax.plot([origin[0], tip[0]], [origin[1], tip[1]],
                    [origin[2], tip[2]], color)
        name = cameranames[i] if cameranames else f"cam{i}"
        ax.text(*origin, name)
    if d["boards"] is not None:
        for pts in d["boards"]:
            ax.plot(pts[:, 0], pts[:, 1], pts[:, 2], ".", markersize=1,
                    alpha=0.4)
    points = d["points"]
    if points is not None:
        ax.plot(points[:, 0], points[:, 1], points[:, 2], "k.",
                markersize=2)
        if point_labels:
            for i, label in point_labels.items():
                ax.text(*points[int(i)], str(label))
    ax.set_xlabel(kwargs.get("xlabel", "x"))
    ax.set_ylabel(kwargs.get("ylabel", "y"))
    ax.set_zlabel(kwargs.get("zlabel", "z"))
    return _finish(fig, hardcopy)


# ----------------------------------------------------------------------------
# overlays
# ----------------------------------------------------------------------------

def _overlay_observations(ax, model_or_oi, icam_intrinsics=None):
    """Scatter this camera's calibration-time board corners over the
    plot: inliers as dots, outliers as red crosses."""
    oi = (model_or_oi.optimization_inputs()
          if hasattr(model_or_oi, "optimization_inputs") else model_or_oi)
    if oi is None:
        return
    if icam_intrinsics is None and \
            hasattr(model_or_oi, "icam_intrinsics"):
        icam_intrinsics = model_or_oi.icam_intrinsics()
    obs = oi.get("observations_board")
    idx = oi.get("indices_frame_camintrinsics_camextrinsics")
    if obs is None or idx is None:
        return
    obs = np.asarray(obs)
    idx = np.asarray(idx)
    if icam_intrinsics is not None:
        obs = obs[idx[:, 1] == icam_intrinsics]
    q = obs.reshape(-1, 3)
    inl = q[:, 2] > 0
    ax.plot(q[inl, 0], q[inl, 1], ".", ms=1, color="black", alpha=0.25,
            label="observations")
    if np.any(~inl):
        ax.plot(q[~inl, 0], q[~inl, 1], "x", ms=3, color="red", alpha=0.6,
                label="outliers")


def _overlay_valid_region(ax, model, color="green"):
    """Draw the model's valid-intrinsics region polygon."""
    if not hasattr(model, "valid_intrinsics_region"):
        return
    region = model.valid_intrinsics_region()
    if region is None:
        return
    region = np.asarray(region)
    ax.plot(region[:, 0], region[:, 1], "-", color=color, lw=1.5,
            label="valid-intrinsics region")


def _draw_contours(fig, ax, qx, qy, z, *, contour_increment=None,
                   contour_labels_font=None, contour_labels_styles=None,
                   cbmax=None):
    """Labeled iso-value contours over a heatmap.  contour_increment: the
    spacing of the levels (None or <= 0: matplotlib's ~10 levels);
    contour_labels_font: the labels' font size (a gnuplot font string
    like ',10' gives its size); contour_labels_styles is accepted and
    ignored."""
    levels = None
    if contour_increment is not None and contour_increment > 0:
        top = cbmax if cbmax else float(np.nanmax(z))
        levels = np.arange(0, top + contour_increment, contour_increment)
        if len(levels) < 2:
            levels = None
    fontsize = 7
    if contour_labels_font is not None:
        try:
            fontsize = float(str(contour_labels_font).split(",")[-1])
        except ValueError:
            pass
    cs = (ax.contour(qx, qy, z, levels=levels, colors="white",
                     linewidths=0.7) if levels is not None
          else ax.contour(qx, qy, z, colors="white", linewidths=0.7))
    ax.clabel(cs, inline=True, fontsize=fontsize)


# ----------------------------------------------------------------------------
# projection analyses
# ----------------------------------------------------------------------------

def _projection_diff_data(models, *, gridn_width, gridn_height, distance,
                          intrinsics_only, use_uncertainties, focus_center,
                          focus_radius, implied_Rt10, device):
    """projection_diff's (difflen, diff or None, q0, implied_Rt10) as
    numpy arrays."""
    from .model_analysis import projection_diff
    difflen, diff, q0, Rt10 = projection_diff(
        models, gridn_width=gridn_width, gridn_height=gridn_height,
        distance=distance, intrinsics_only=intrinsics_only,
        use_uncertainties=use_uncertainties,
        focus_center=focus_center, focus_radius=focus_radius,
        implied_Rt10=implied_Rt10, device=device)
    return (_np(difflen), None if diff is None else _np(diff), _np(q0),
            _np(Rt10))


def show_projection_diff(models, *, gridn_width=60, gridn_height=None,
                         distance=None, vectorfield=False,
                         vectorscale=1.0,
                         intrinsics_only=False,
                         use_uncertainties=False,
                         focus_center=None, focus_radius=-1,
                         implied_Rt10=None,
                         observations=False,
                         valid_intrinsics_region=False,
                         directions=False,
                         contours=False, contour_increment=None,
                         contour_labels_font=None,
                         contour_labels_styles=None,
                         cbmax=4, title=None, extratitle=None,
                         hardcopy=None, device=None, **kwargs):
    """Heatmap or vectorfield of the projection difference between models.
    More than 2 models: the RMS heatmap against model 0 (a vectorfield
    needs exactly 2).  observations, valid_intrinsics_region and contours
    overlay the calibration's observations, each model's valid region and
    labeled contours; directions=True colors the vectorfield by direction
    (hsv); implied_Rt10 is used instead of a fitted transform.  Returns
    (Figure, difflen)."""
    device = resolve_device(device)
    difflen, diff, q0, _ = _projection_diff_data(
        models, gridn_width=gridn_width, gridn_height=gridn_height,
        distance=distance, intrinsics_only=intrinsics_only,
        use_uncertainties=use_uncertainties, focus_center=focus_center,
        focus_radius=focus_radius, implied_Rt10=implied_Rt10,
        device=device)
    if (vectorfield or directions) and diff is None:
        raise Exception("vectorfield/directions need exactly 2 models")
    fig, ax = _new_axes(_title("Projection diff (pixels)", title,
                               extratitle))
    if vectorfield or directions:
        color = (np.degrees(np.arctan2(diff[..., 1], diff[..., 0]))
                 if directions else difflen)
        qv = ax.quiver(q0[..., 0], q0[..., 1],
                       diff[..., 0] * vectorscale,
                       diff[..., 1] * vectorscale, color,
                       cmap="hsv" if directions else None,
                       clim=(-180, 180) if directions else None)
        fig.colorbar(qv, ax=ax)
        ax.invert_yaxis()
    else:
        im = ax.imshow(difflen, origin="upper", vmin=0, vmax=cbmax,
                       extent=_extent(q0))
        fig.colorbar(im, ax=ax)
        if contours or contour_increment is not None:
            _draw_contours(fig, ax, q0[..., 0], q0[..., 1], difflen,
                           contour_increment=contour_increment,
                           contour_labels_font=contour_labels_font,
                           contour_labels_styles=contour_labels_styles,
                           cbmax=cbmax)
    if observations:
        _overlay_observations(ax, models[0])
    if valid_intrinsics_region:
        for m, c in zip(models, ("green", "orange", "cyan", "magenta")):
            _overlay_valid_region(ax, m, color=c)
    return _finish(fig, hardcopy), difflen


def _projection_uncertainty_data(model, *, gridn_width, gridn_height,
                                 distance, isotropic, method,
                                 observed_pixel_uncertainty, device):
    """The uncertainty grid (gridn_height, gridn_width) and its pixels q
    (..., 2), numpy."""
    from .model_analysis import projection_uncertainty
    from .utils import sample_imager_unproject
    W, H = model.imagersize()
    v, q = sample_imager_unproject(gridn_width, gridn_height, W, H,
                                   *model.intrinsics(), normalize=True,
                                   device=device)
    d = distance if distance is not None else 1e5
    what = "rms-stdev" if isotropic else "worstdirection-stdev"
    unc = projection_uncertainty(
        (v * d).reshape(-1, 3), model, method=method, what=what,
        observed_pixel_uncertainty=observed_pixel_uncertainty,
        device=device)
    q = _np(q)
    return _np(unc).reshape(q.shape[:-1]), q


def show_projection_uncertainty(model, *, gridn_width=30, gridn_height=None,
                                distance=None, isotropic=False,
                                method="mean-pcam",
                                observations=False,
                                valid_intrinsics_region=False,
                                contours=False, contour_increment=None,
                                contour_labels_font=None,
                                contour_labels_styles=None,
                                cbmax=3, title=None, extratitle=None,
                                hardcopy=None,
                                observed_pixel_uncertainty=None,
                                device=None, **kwargs):
    """Heatmap of the projection uncertainty over the imager, at
    `distance` (None: 1e5 m).  observations=True overlays the calibration's
    corners (their density shapes this map), valid_intrinsics_region=True
    the region, contours=True labeled contours.  Returns (Figure,
    uncertainty grid)."""
    device = resolve_device(device)
    unc, q = _projection_uncertainty_data(
        model, gridn_width=gridn_width, gridn_height=gridn_height,
        distance=distance, isotropic=isotropic, method=method,
        observed_pixel_uncertainty=observed_pixel_uncertainty,
        device=device)
    fig, ax = _new_axes(_title(f"Projection uncertainty (pixels), "
                               f"distance={distance}", title, extratitle))
    im = ax.imshow(unc, origin="upper", vmin=0, vmax=cbmax,
                   extent=_extent(q))
    fig.colorbar(im, ax=ax)
    if contours or contour_increment is not None:
        _draw_contours(fig, ax, q[..., 0], q[..., 1], unc,
                       contour_increment=contour_increment,
                       contour_labels_font=contour_labels_font,
                       contour_labels_styles=contour_labels_styles,
                       cbmax=cbmax)
    if observations:
        _overlay_observations(ax, model)
    if valid_intrinsics_region:
        _overlay_valid_region(ax, model)
    return _finish(fig, hardcopy), unc


def _uncertainty_vs_distance_data(model, *, where, distance_min,
                                  distance_max, Ndistances, method,
                                  isotropic, observed_pixel_uncertainty,
                                  device):
    """(distances, uncertainty) along the ray of the pixel `where`,
    numpy."""
    from .model_analysis import projection_uncertainty
    from .projections import unproject
    W, H = model.imagersize()
    if isinstance(where, str):
        if where == "centroid" and model.optimization_inputs() is not None:
            oi = model.optimization_inputs()
            obs = np.asarray(oi["observations_board"])
            idx = np.asarray(
                oi["indices_frame_camintrinsics_camextrinsics"])
            sel = idx[:, 1] == model.icam_intrinsics()
            qq = obs[sel].reshape(-1, 3)
            qq = qq[qq[:, 2] > 0]
            q = (qq[:, :2].mean(axis=0) if len(qq)
                 else np.array([(W - 1) / 2, (H - 1) / 2]))
        else:
            q = np.array([(W - 1) / 2, (H - 1) / 2])
    else:
        q = np.asarray(where)
    v = _np(unproject(q, *model.intrinsics(), normalize=True,
                      device=device))
    distances = np.geomspace(distance_min, distance_max, Ndistances)
    p = v[None, :] * distances[:, None]
    unc = projection_uncertainty(
        p, model, method=method,
        what="rms-stdev" if isotropic else "worstdirection-stdev",
        observed_pixel_uncertainty=observed_pixel_uncertainty,
        device=device)
    return distances, _np(unc)


def show_projection_uncertainty_vs_distance(
        model, *, where="centroid", distance_min=0.2, distance_max=100.0,
        Ndistances=40, method="mean-pcam", isotropic=False,
        observed_pixel_uncertainty=None,
        title=None, extratitle=None, hardcopy=None, device=None,
        **kwargs):
    """The uncertainty along one observation ray against its range.
    where: 'center' (the imager's center), 'centroid' (the mean of the
    calibration's observations) or a (2,) pixel; isotropic=True plots the
    rms-stdev instead of the worst direction's.  Returns (Figure,
    uncertainty)."""
    device = resolve_device(device)
    distances, unc = _uncertainty_vs_distance_data(
        model, where=where, distance_min=distance_min,
        distance_max=distance_max, Ndistances=Ndistances, method=method,
        isotropic=isotropic,
        observed_pixel_uncertainty=observed_pixel_uncertainty,
        device=device)
    fig, ax = _new_axes(_title("Uncertainty vs distance", title,
                               extratitle))
    ax.semilogx(distances, unc)
    ax.set_xlabel("distance [m]")
    ax.set_ylabel(("rms" if isotropic else "worst-direction")
                  + " stdev [pixels]")
    ax.grid(True)
    return _finish(fig, hardcopy), unc


# ----------------------------------------------------------------------------
# lens plots
# ----------------------------------------------------------------------------

def _distortion_off_pinhole_data(model, *, gridn_width, gridn_height,
                                 device):
    """The grid q (..., 2) and the pinhole core's projection minus q,
    numpy."""
    from .projections import project
    from .utils import sample_imager_unproject
    lensmodel, intr = model.intrinsics()
    W, H = model.imagersize()
    v, q = sample_imager_unproject(gridn_width, gridn_height, W, H,
                                   lensmodel, intr, device=device)
    q_pinhole = project(v, "LENSMODEL_PINHOLE", np.asarray(intr[:4]),
                        device=device)
    return _np(q), _np(q_pinhole - q)


def show_distortion_off_pinhole(model, *, vectorfield=False, gridn_width=60,
                                gridn_height=None, cbmax=25.0,
                                vectorscale=1.0,
                                title=None, extratitle=None,
                                hardcopy=None, device=None, **kwargs):
    """How far the projection is from that of the pinhole core."""
    device = resolve_device(device)
    q, diff = _distortion_off_pinhole_data(
        model, gridn_width=gridn_width, gridn_height=gridn_height,
        device=device)
    fig, ax = _new_axes(_title("Distortion off pinhole (pixels)", title,
                               extratitle))
    if vectorfield:
        ax.quiver(q[..., 0], q[..., 1], diff[..., 0] * vectorscale,
                  diff[..., 1] * vectorscale)
        ax.invert_yaxis()
    else:
        difflen = np.linalg.norm(diff, axis=-1)
        im = ax.imshow(difflen, origin="upper", vmin=0, vmax=cbmax,
                       extent=_extent(q))
        fig.colorbar(im, ax=ax)
    return _finish(fig, hardcopy)


def _radial_data(model, *, device):
    """(th in degrees, r_obs, r_pinhole) along the diagonal from the
    center, numpy."""
    from .projections import unproject
    lensmodel, intr = model.intrinsics()
    W, H = model.imagersize()
    fx, fy, cx, cy = np.asarray(intr)[:4]
    t = np.linspace(0, 1, 100)
    q = np.stack([cx + t * (W - 1 - cx), cy + t * (H - 1 - cy)], axis=-1)
    v = _np(unproject(q, lensmodel, intr, device=device))
    th = np.degrees(np.arctan2(np.linalg.norm(v[:, :2], axis=-1), v[:, 2]))
    r_obs = np.linalg.norm((q - [cx, cy]) / [fx, fy], axis=-1)
    r_pinhole = np.tan(np.radians(th))
    return th, r_obs, r_pinhole


def show_distortion_off_pinhole_radial(model, *,
                                       show_fisheye_projections=False,
                                       title=None, extratitle=None,
                                       hardcopy=None, device=None,
                                       **kwargs):
    """The radial distortion profile along the imager's diagonal;
    show_fisheye_projections=True overlays the ideal fisheye projections
    (equidistant, equisolid-angle, orthographic, stereographic)."""
    device = resolve_device(device)
    th, r_obs, r_pinhole = _radial_data(model, device=device)
    fig, ax = _new_axes(_title("Radial distortion", title, extratitle))
    ax.plot(th, r_obs - r_pinhole, label="this model")
    if show_fisheye_projections:
        thr = np.radians(th)
        for name, r in (("equidistant", thr),
                        ("equisolid", 2.0 * np.sin(thr / 2.0)),
                        ("orthographic", np.sin(thr)),
                        ("stereographic", 2.0 * np.tan(thr / 2.0))):
            ax.plot(th, r - r_pinhole, "--", lw=1, label=name)
        ax.legend()
    ax.set_xlabel("angle off the optical axis [deg]")
    ax.set_ylabel("normalized radial distortion delta")
    ax.grid(True)
    return _finish(fig, hardcopy)


def show_valid_intrinsics_region(models, *, image=None, points=None,
                                 cameranames=None, title=None,
                                 extratitle=None, hardcopy=None,
                                 device=None, **kwargs):
    """The valid-intrinsics region(s) of the model(s), over `image` (an
    array or a file) if given.  points: (N, 2) pixels to overlay;
    cameranames label the regions in the legend.  Nothing here runs on
    the device; device is taken as every show_* takes it."""
    resolve_device(device)
    if hasattr(models, "intrinsics"):
        models = [models]
    arr = None
    if image is not None:
        arr = image if isinstance(image, np.ndarray) else None
        if arr is None:
            from .image import load_image
            arr = load_image(image)
    regions = [m.valid_intrinsics_region() for m in models]
    fig, ax = _new_axes(_title("Valid-intrinsics region", title,
                               extratitle))
    if arr is not None:
        ax.imshow(arr, cmap="gray")
    for i, r in enumerate(regions):
        if r is not None:
            name = (cameranames[i] if cameranames else f"camera {i}")
            ax.plot(r[:, 0], r[:, 1], "-", label=name)
    if points is not None:
        points = np.asarray(points)
        ax.plot(points[:, 0], points[:, 1], "r.", ms=4)
    if cameranames or points is not None:
        ax.legend()
    return _finish(fig, hardcopy)


def _splined_correction_data(model, *, gridn_width, gridn_height, device):
    """A splined model's deltau over the imager grid: (du (..., 2), q
    (..., 2), u (..., 2), (ux, uy) knots), numpy."""
    from .lensmodels import (knots_for_splined_models, parse_lensmodel,
                             splined_deltau, stereographic_uv)
    from .utils import sample_imager_unproject
    lensmodel, intr = model.intrinsics()
    lm = parse_lensmodel(lensmodel)
    if lm.family != "LENSMODEL_SPLINED_STEREOGRAPHIC":
        raise Exception("show_splined_model_correction requires a splined "
                        "model")
    W, H = model.imagersize()
    v, q = sample_imager_unproject(gridn_width, gridn_height, W, H,
                                   lensmodel, intr, device=device)
    u = stereographic_uv(v)
    coeffs = torch.as_tensor(np.asarray(intr[4:], dtype=np.float64),
                             device=u.device).reshape(lm.Ny, lm.Nx, 2)
    du = splined_deltau(u, coeffs, lm)
    knots = tuple(_np(k) for k in knots_for_splined_models(
        lensmodel, device=u.device))
    return _np(du), _np(q), _np(u), knots


def show_splined_model_correction(model, *, vectorfield=False,
                                  vectorscale=1.0, xy=None,
                                  imager_domain=True,
                                  gridn_width=60, gridn_height=None,
                                  observations=False,
                                  valid_intrinsics_region=False,
                                  title=None, extratitle=None,
                                  hardcopy=None, device=None, **kwargs):
    """The spline's deltau correction surface.  xy='x' or 'y' shows that
    surface alone, signed; by default |deltau|.  imager_domain=False plots
    over the stereographic u domain, the spline's own, where the knots
    (drawn) are regular."""
    device = resolve_device(device)
    du, q, u, (ux, uy) = _splined_correction_data(
        model, gridn_width=gridn_width, gridn_height=gridn_height,
        device=device)
    dom = q if imager_domain else u
    fig, ax = _new_axes(_title(
        "Splined model correction deltau" +
        (f" ({xy} surface)" if xy else ""), title, extratitle))
    if vectorfield:
        ax.quiver(dom[..., 0], dom[..., 1], du[..., 0] * vectorscale,
                  du[..., 1] * vectorscale)
        if imager_domain:
            ax.invert_yaxis()
    else:
        z = (du[..., 0 if xy == "x" else 1] if xy
             else np.linalg.norm(du, axis=-1))
        im = ax.imshow(z, origin="upper", extent=_extent(dom))
        fig.colorbar(im, ax=ax)
        if not imager_domain:
            gx, gy = np.meshgrid(ux, uy)
            ax.plot(gx.ravel(), gy.ravel(), ".", ms=1.5, color="white",
                    alpha=0.6)
    if observations and imager_domain:
        _overlay_observations(ax, model)
    if valid_intrinsics_region and imager_domain:
        _overlay_valid_region(ax, model)
    return _finish(fig, hardcopy)


# ----------------------------------------------------------------------------
# residuals
# ----------------------------------------------------------------------------

def _model_or_oi(model_or_oi, icam_intrinsics):
    """A cameramodel holding optimization_inputs (its camera selects
    itself), or optimization_inputs and icam: (oi, icam, model or
    None)."""
    if hasattr(model_or_oi, "optimization_inputs"):
        oi = model_or_oi.optimization_inputs()
        if oi is None:
            raise Exception("model has no optimization_inputs")
        if icam_intrinsics is None:
            icam_intrinsics = model_or_oi.icam_intrinsics()
        return oi, icam_intrinsics, model_or_oi
    return model_or_oi, icam_intrinsics, None


def _board_residuals(optimization_inputs, x=None, icam_intrinsics=None,
                     residuals=None, *, device):
    """The board residuals (Nobs, H, W, 2), the observations (Nobs, H, W,
    3) and their indices (Nobs, 3), of camera icam_intrinsics alone if
    given, numpy.  x (or its synonym residuals) defaults to
    optimizer_callback's at the solve's state."""
    from .optimize.jacobian import optimizer_callback
    from .optimize.layout import normalize_inputs, spec_from_inputs
    if x is None:
        x = residuals
    kw = normalize_inputs(optimization_inputs)
    spec = spec_from_inputs(**kw)
    if x is None:
        _, x, _ = optimizer_callback(no_jacobian=True, device=device, **kw)
    H = spec.calibration_object_height_n
    W = spec.calibration_object_width_n
    res = _np(x)[:spec.num_measurements_boards].reshape(-1, H, W, 2)
    obs = np.asarray(kw["observations_board"])
    idx = np.asarray(kw["indices_frame_camintrinsics_camextrinsics"])
    if icam_intrinsics is not None:
        sel = idx[:, 1] == icam_intrinsics
        res, obs, idx = res[sel], obs[sel], idx[sel]
    return res, obs, idx


def _board_observation_data(optimization_inputs, i_observation, *,
                            from_worst, i_observations_sorted_from_worst,
                            x, residuals, device):
    """The observation shown (its index after the worst-first order), its
    corners (H, W, 3), its residuals (H, W, 2) and its (frame, camera)."""
    res, obs, idx = _board_residuals(optimization_inputs, x=x,
                                     residuals=residuals, device=device)
    if i_observations_sorted_from_worst is not None:
        i_observation = int(
            i_observations_sorted_from_worst[i_observation])
    elif from_worst:
        worst = np.max(np.linalg.norm(res, axis=-1).reshape(
            len(res), -1), axis=-1)
        order = np.argsort(-worst)
        i_observation = int(order[i_observation])
    return (i_observation, obs[i_observation], res[i_observation],
            int(idx[i_observation][0]), int(idx[i_observation][1]))


def show_residuals_board_observation(optimization_inputs, i_observation,
                                     *, from_worst=False,
                                     i_observations_sorted_from_worst=None,
                                     x=None, residuals=None,
                                     paths=None, image_path_prefix=None,
                                     image_directory=None, showimage=True,
                                     vectorscale=20, circlescale=1.0,
                                     cbmax=None, title=None,
                                     extratitle=None,
                                     hardcopy=None, device=None, **kwargs):
    """The residual vectorfield of one board observation.

    from_worst=True indexes the observations by their worst residual,
    largest first (i_observation=0 is the worst);
    i_observations_sorted_from_worst gives that order precomputed.  paths
    (each observation's image, rewritten by image_path_prefix or
    image_directory) with showimage=True draws the image underneath.
    circlescale scales the outliers' markers."""
    device = resolve_device(device)
    i_observation, o, r, iframe, ici = _board_observation_data(
        optimization_inputs, i_observation, from_worst=from_worst,
        i_observations_sorted_from_worst=i_observations_sorted_from_worst,
        x=x, residuals=residuals, device=device)
    rms = float(np.sqrt(np.mean(np.sum(r * r, axis=-1))))
    fig, ax = _new_axes(_title(
        f"Residuals: observation {i_observation} "
        f"(frame {iframe}, cam {ici}); rms {rms:.3f} px", title,
        extratitle))
    if paths is not None and showimage:
        path = paths[i_observation]
        if image_path_prefix is not None:
            path = os.path.join(image_path_prefix, path)
        elif image_directory is not None:
            path = os.path.join(image_directory, os.path.basename(path))
        try:
            from .image import load_image
            ax.imshow(np.asarray(load_image(path, bits_per_pixel=8,
                                            channels=1)), cmap="gray")
        except OSError as e:
            import warnings
            warnings.warn(f"could not load image '{path}': {e}",
                          stacklevel=2)
    mag = np.linalg.norm(r, axis=-1)
    qv = ax.quiver(o[..., 0], o[..., 1], r[..., 0], r[..., 1], mag,
                   clim=(0, cbmax) if cbmax else None)
    fig.colorbar(qv, ax=ax)
    out = o[..., 2] <= 0
    if np.any(out):
        ax.plot(o[..., 0][out], o[..., 1][out], "o", ms=8 * circlescale,
                mfc="none", mec="red", label="outliers")
        ax.legend()
    ax.invert_yaxis()
    return _finish(fig, hardcopy)


def _inlier_residuals(model, x, residuals, icam_intrinsics, device):
    """The inlier corners' pixels (N, 2) and residuals (N, 2) of the
    camera, and the model (None for optimization_inputs)."""
    oi, icam_intrinsics, m = _model_or_oi(model, icam_intrinsics)
    res, obs, _ = _board_residuals(oi, x, icam_intrinsics, residuals,
                                   device=device)
    inlier = obs[..., 2] > 0
    return obs[..., :2][inlier], res[inlier], m


def show_residuals_histogram(optimization_inputs, icam_intrinsics=None,
                             x=None, residuals=None, *,
                             binwidth=0.02, title=None, extratitle=None,
                             hardcopy=None, device=None, **kwargs):
    """The histogram of the inliers' residuals, with a gaussian of their
    standard deviation."""
    device = resolve_device(device)
    _, r, _ = _inlier_residuals(optimization_inputs, x, residuals,
                                icam_intrinsics, device)
    r = r.ravel()
    fig, ax = _new_axes(_title("Residual histogram", title, extratitle))
    ax.hist(r, bins=np.arange(r.min(), r.max() + binwidth, binwidth),
            density=True, alpha=0.7)
    s = r.std()
    xs = np.linspace(r.min(), r.max(), 200)
    ax.plot(xs, np.exp(-xs * xs / (2 * s * s)) / np.sqrt(2 * np.pi * s * s))
    ax.set_xlabel("residual [pixels]")
    return _finish(fig, hardcopy)


def show_residuals_vectorfield(model, x=None, residuals=None, *,
                               icam_intrinsics=None,
                               vectorscale=20, cbmax=None,
                               valid_intrinsics_region=True,
                               title=None, extratitle=None, hardcopy=None,
                               device=None, **kwargs):
    """Every inlier residual as a vector over the imager.  A cameramodel
    selects its own camera and draws its valid-intrinsics region by
    default; optimization_inputs work too."""
    device = resolve_device(device)
    q, r, m = _inlier_residuals(model, x, residuals, icam_intrinsics,
                                device)
    fig, ax = _new_axes(_title("Residual vectorfield", title, extratitle))
    qv = ax.quiver(q[:, 0], q[:, 1], r[:, 0] * vectorscale,
                   r[:, 1] * vectorscale,
                   np.linalg.norm(r, axis=-1),
                   clim=(0, cbmax) if cbmax else None)
    fig.colorbar(qv, ax=ax)
    if valid_intrinsics_region and m is not None:
        _overlay_valid_region(ax, m)
    ax.invert_yaxis()
    return _finish(fig, hardcopy)


def show_residuals_magnitudes(model, x=None, residuals=None, *,
                              icam_intrinsics=None,
                              cbmax=None, valid_intrinsics_region=True,
                              title=None, extratitle=None, hardcopy=None,
                              device=None, **kwargs):
    """The inlier residuals' magnitudes as a scatter over the imager."""
    device = resolve_device(device)
    q, r, m = _inlier_residuals(model, x, residuals, icam_intrinsics,
                                device)
    mag = np.linalg.norm(r, axis=-1)
    fig, ax = _new_axes(_title("Residual magnitudes", title, extratitle))
    sc = ax.scatter(q[:, 0], q[:, 1], c=mag, s=4, vmax=cbmax)
    fig.colorbar(sc, ax=ax)
    if valid_intrinsics_region and m is not None:
        _overlay_valid_region(ax, m)
    ax.invert_yaxis()
    return _finish(fig, hardcopy)


def show_residuals_directions(model, x=None, residuals=None, *,
                              icam_intrinsics=None,
                              valid_intrinsics_region=True,
                              title=None, extratitle=None, hardcopy=None,
                              device=None, **kwargs):
    """The inlier residuals' directions over the imager: a systematic
    pattern says the lens model cannot fit the data."""
    device = resolve_device(device)
    q, r, m = _inlier_residuals(model, x, residuals, icam_intrinsics,
                                device)
    th = np.degrees(np.arctan2(r[:, 1], r[:, 0]))
    fig, ax = _new_axes(_title("Residual directions", title, extratitle))
    sc = ax.scatter(q[:, 0], q[:, 1], c=th, cmap="hsv", s=4,
                    vmin=-180, vmax=180)
    fig.colorbar(sc, ax=ax)
    if valid_intrinsics_region and m is not None:
        _overlay_valid_region(ax, m)
    ax.invert_yaxis()
    return _finish(fig, hardcopy)


def _regional_data(model, x, residuals, icam_intrinsics, gridn_width,
                   gridn_height, device):
    """The mean inlier residual magnitude in each cell of a
    (gridn_height, gridn_width) grid over the imager (NaN where empty),
    the imager's (W, H) and the model (or None)."""
    from .optimize.layout import normalize_inputs, spec_from_inputs
    oi, icam_intrinsics, m = _model_or_oi(model, icam_intrinsics)
    kw = normalize_inputs(oi)
    W, H = spec_from_inputs(**kw).imagersizes[0]
    if gridn_height is None:
        gridn_height = int(round(H / W * gridn_width))
    q, r, _ = _inlier_residuals(kw, x, residuals, icam_intrinsics, device)
    mag = np.linalg.norm(r, axis=-1)
    gx = np.clip((q[:, 0] / W * gridn_width).astype(int), 0, gridn_width - 1)
    gy = np.clip((q[:, 1] / H * gridn_height).astype(int), 0,
                 gridn_height - 1)
    sums = np.zeros((gridn_height, gridn_width))
    counts = np.zeros((gridn_height, gridn_width))
    np.add.at(sums, (gy, gx), mag)
    np.add.at(counts, (gy, gx), 1)
    mean = np.where(counts > 0, sums / np.maximum(counts, 1), np.nan)
    return mean, (W, H), m


def show_residuals_regional(model, x=None, residuals=None, *,
                            icam_intrinsics=None,
                            gridn_width=20, gridn_height=None,
                            valid_intrinsics_region=True,
                            title=None, extratitle=None, hardcopy=None,
                            device=None, **kwargs):
    """The mean residual magnitude in regions of the imager.  Returns
    (Figure, the regions' means)."""
    device = resolve_device(device)
    mean, (W, H), m = _regional_data(model, x, residuals, icam_intrinsics,
                                     gridn_width, gridn_height, device)
    fig, ax = _new_axes(_title("Regional mean residual [pixels]", title,
                               extratitle))
    im = ax.imshow(mean, origin="upper", extent=(0, W, H, 0))
    fig.colorbar(im, ax=ax)
    if valid_intrinsics_region and m is not None:
        _overlay_valid_region(ax, m)
    return _finish(fig, hardcopy), mean


# ----------------------------------------------------------------------------
# host helpers
# ----------------------------------------------------------------------------

def annotate_image__valid_intrinsics_region(image, model, *,
                                            color=(0, 0, 255)):
    """Draw the model's valid-intrinsics region into a BGR (or gray)
    image, in place."""
    region = model.valid_intrinsics_region()
    if region is None:
        return image
    pts = np.asarray(region).astype(int)
    for i in range(len(pts) - 1):
        _draw_line(image, pts[i], pts[i + 1], color)
    return image


def _draw_line(img, p0, p1, color):
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1))
    xs = np.linspace(p0[0], p1[0], n + 1).astype(int)
    ys = np.linspace(p0[1], p1[1], n + 1).astype(int)
    ok = (xs >= 0) & (xs < img.shape[1]) & (ys >= 0) & (ys < img.shape[0])
    if img.ndim == 3:
        img[ys[ok], xs[ok]] = color
    else:
        img[ys[ok], xs[ok]] = color[0]


def _stereo_pair_diff_data(model_pairs, *, gridn_width, gridn_height,
                           distance, device):
    """stereo_pair_diff's (difflen, diff, q0), numpy."""
    from .model_analysis import stereo_pair_diff
    return tuple(_np(a) for a in stereo_pair_diff(
        model_pairs, gridn_width=gridn_width, gridn_height=gridn_height,
        distance=distance, device=device))


def show_stereo_pair_diff(model_pairs, *, gridn_width=60, gridn_height=None,
                          distance=None, vectorfield=False, vectorscale=1.0,
                          observations=False,
                          valid_intrinsics_region=False,
                          cbmax=4, title=None, extratitle=None,
                          hardcopy=None, device=None, **kwargs):
    """Heatmap or vectorfield of the camera-0 -> camera-1 reprojection
    mismatch between two calibrations of one stereo pair.  Returns
    (Figure, difflen)."""
    device = resolve_device(device)
    difflen, diff, q0 = _stereo_pair_diff_data(
        model_pairs, gridn_width=gridn_width, gridn_height=gridn_height,
        distance=distance, device=device)
    fig, ax = _new_axes(_title("Stereo-pair diff (pixels)", title,
                               extratitle))
    if vectorfield:
        qv = ax.quiver(q0[..., 0], q0[..., 1],
                       diff[..., 0] * vectorscale,
                       diff[..., 1] * vectorscale, difflen)
        fig.colorbar(qv, ax=ax)
        ax.invert_yaxis()
    else:
        im = ax.imshow(difflen, origin="upper", vmin=0, vmax=cbmax,
                       extent=_extent(q0))
        fig.colorbar(im, ax=ax)
    if observations:
        _overlay_observations(ax, model_pairs[0][0])
    if valid_intrinsics_region:
        _overlay_valid_region(ax, model_pairs[0][0])
    return _finish(fig, hardcopy), difflen


def fitted_gaussian_equation(*, binwidth, x=None, mean=None, sigma=None,
                             N=None, legend=None):
    """gnuplot's 'equation' string of a gaussian PDF scaled to overlay a
    histogram of bins `binwidth` wide: k = N sqrt(2 pi) sigma
    erf(binwidth / (2 sqrt(2) sigma)), so that its peak meets the central
    bin's expected count.  Give the samples x, or (mean, sigma, N)."""
    from scipy.special import erf
    if x is not None:
        if mean is not None or sigma is not None or N is not None:
            raise Exception("pass either x or (mean, sigma, N), not both")
        x = np.asarray(x)
        sigma = float(np.std(x))
        mean = float(np.mean(x))
        N = len(x)
    elif mean is None or sigma is None or N is None:
        raise Exception("without x, all of (mean, sigma, N) are required")
    var = sigma * sigma
    k = N * np.sqrt(2. * np.pi) * sigma * \
        erf(binwidth / (2. * np.sqrt(2.) * sigma))
    title = 'notitle' if legend is None else f'title "{legend}"'
    return (f'{k}*exp(-(x-{mean})*(x-{mean})/(2.*{var})) / '
            f'sqrt(2.*pi*{var}) {title} with lines lw 2')


def imagergrid_using(imagersize, gridn_width, gridn_height=None):
    """gnuplot's 'using' expression that maps grid indices to pixels on
    an imager colormap plot."""
    W, H = imagersize
    if gridn_height is None:
        gridn_height = int(round(H / W * gridn_width))
    return '($1*{}):($2*{}):3'.format(float(W - 1) / (gridn_width - 1),
                                      float(H - 1) / (gridn_height - 1))
