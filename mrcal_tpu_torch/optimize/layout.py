"""State-vector and measurement-vector layout (pure numpy).

A copy of ``mrcal_tpu/optimize/layout.py``, trimmed to what the
parametric board, discrete-point and triangulated-point calibrations use.
Semantics are the reference's:

State order:    intrinsics (per cam: [core if optimized] + [distortions if
                optimized]) -> extrinsics (6/cam) -> frames (6/frame) ->
                points (3/point, only Npoints-Npoints_fixed variable) ->
                calobject_warp (2)
Measurements:   boards -> points -> triangulated points -> regularization

Triangulated points are not state variables: each set of N observations
of one point gives N(N-1)/2 scalar ray-divergence measurements.
"""

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

from ..lensmodels import parse_lensmodel, LensModel

# packing scales (reference: scales.h:40-48)
SCALE_INTRINSICS_FOCAL_LENGTH = 500.0
SCALE_INTRINSICS_CENTER_PIXEL = 20.0
SCALE_ROTATION_CAMERA = 0.1 * np.pi / 180.0
SCALE_TRANSLATION_CAMERA = 1.0
SCALE_ROTATION_FRAME = 15.0 * np.pi / 180.0
SCALE_TRANSLATION_FRAME = 1.0
SCALE_POSITION_POINT = SCALE_TRANSLATION_FRAME
SCALE_CALOBJECT_WARP = 0.01
SCALE_DISTORTION = 1.0


@dataclass(frozen=True)
class ProblemSelections:
    """mrcal_problem_selections_t equivalent."""
    do_optimize_intrinsics_core: bool = True
    do_optimize_intrinsics_distortions: bool = True
    do_optimize_extrinsics: bool = True
    do_optimize_frames: bool = True
    do_optimize_calobject_warp: bool = True
    do_apply_regularization: bool = True
    do_apply_outlier_rejection: bool = True
    do_apply_regularization_unity_cam01: bool = False


@dataclass(frozen=True)
class ProblemSpec:
    """Static description of an optimization problem: everything that
    determines shapes and ordering."""
    lensmodel: LensModel
    Ncameras_intrinsics: int
    Ncameras_extrinsics: int
    Nframes: int
    Npoints: int
    Npoints_fixed: int
    Nobservations_board: int
    Nobservations_point: int
    # triangulated points: tuple of set sizes (each set = observations of one
    # point); empty if none
    triangulated_set_sizes: Tuple[int, ...] = ()
    calibration_object_width_n: int = 0
    calibration_object_height_n: int = 0
    calibration_object_spacing: float = 0.0
    imagersizes: Tuple[Tuple[int, int], ...] = ()
    selections: ProblemSelections = field(default_factory=ProblemSelections)

    # ---- lens model derived ----
    @property
    def Nintrinsics(self):
        return self.lensmodel.num_params

    @property
    def has_core(self):
        return self.lensmodel.metadata["has_core"]

    @property
    def Ncore(self):
        return 4 if self.has_core else 0

    @property
    def Ndistortions(self):
        return self.Nintrinsics - self.Ncore

    @property
    def is_splined(self):
        return self.lensmodel.family == "LENSMODEL_SPLINED_STEREOGRAPHIC"

    # ---- state layout ----
    @property
    def Ncore_state(self):
        s = self.selections
        return 4 if (s.do_optimize_intrinsics_core and self.has_core) else 0

    @property
    def Nintrinsics_state_per_cam(self):
        s = self.selections
        n = self.Ncore_state
        if s.do_optimize_intrinsics_distortions:
            n += self.Ndistortions
        return n

    @property
    def num_states_intrinsics(self):
        return self.Ncameras_intrinsics * self.Nintrinsics_state_per_cam

    @property
    def num_states_extrinsics(self):
        return (6 * self.Ncameras_extrinsics
                if self.selections.do_optimize_extrinsics else 0)

    @property
    def num_states_frames(self):
        return 6 * self.Nframes if self.selections.do_optimize_frames else 0

    @property
    def Npoints_variable(self):
        return self.Npoints - self.Npoints_fixed

    @property
    def num_states_points(self):
        return (3 * self.Npoints_variable
                if self.selections.do_optimize_frames else 0)

    @property
    def has_calobject_warp(self):
        return (self.selections.do_optimize_calobject_warp
                and self.Nobservations_board > 0)

    @property
    def num_states_calobject_warp(self):
        return 2 if self.has_calobject_warp else 0

    @property
    def state_index_intrinsics0(self):
        return 0

    @property
    def state_index_extrinsics0(self):
        return self.num_states_intrinsics

    @property
    def state_index_frames0(self):
        return self.state_index_extrinsics0 + self.num_states_extrinsics

    @property
    def state_index_points0(self):
        return self.state_index_frames0 + self.num_states_frames

    @property
    def state_index_calobject_warp0(self):
        return self.state_index_points0 + self.num_states_points

    @property
    def Nstate(self):
        return self.state_index_calobject_warp0 + self.num_states_calobject_warp

    # ---- measurement layout ----
    @property
    def num_measurements_boards(self):
        return (self.Nobservations_board * self.calibration_object_width_n *
                self.calibration_object_height_n * 2)

    @property
    def num_measurements_points(self):
        return self.Nobservations_point * 2

    @property
    def num_measurements_points_triangulated(self):
        # each set of N observations of a point yields N*(N-1)/2 pairwise
        # ray-divergence measurements
        return sum(n * (n - 1) // 2 for n in self.triangulated_set_sizes)

    @property
    def num_measurements_regularization(self):
        s = self.selections
        n = 0
        if s.do_apply_regularization:
            if s.do_optimize_intrinsics_distortions:
                n += self.Ncameras_intrinsics * self.Ndistortions
            if s.do_optimize_intrinsics_core and self.has_core:
                n += self.Ncameras_intrinsics * 2
        if (s.do_apply_regularization_unity_cam01
                and s.do_optimize_extrinsics
                and self.Ncameras_extrinsics > 0):
            n += 1
        return n

    @property
    def measurement_index_boards0(self):
        return 0

    @property
    def measurement_index_points0(self):
        return self.num_measurements_boards

    @property
    def measurement_index_points_triangulated0(self):
        return self.measurement_index_points0 + self.num_measurements_points

    @property
    def measurement_index_regularization0(self):
        return (self.measurement_index_points_triangulated0
                + self.num_measurements_points_triangulated)

    @property
    def Nmeasurements(self):
        return (self.measurement_index_regularization0
                + self.num_measurements_regularization)

    # ---- packing scale vector ----
    def scales(self):
        """The per-state-variable packing scale (units of the variable); the
        packed state is b_packed = b / scales."""
        s = self.selections
        parts = []
        per_cam = []
        if self.Ncore_state:
            per_cam += [SCALE_INTRINSICS_FOCAL_LENGTH] * 2 + \
                       [SCALE_INTRINSICS_CENTER_PIXEL] * 2
        if s.do_optimize_intrinsics_distortions:
            per_cam += [SCALE_DISTORTION] * self.Ndistortions
        parts += per_cam * self.Ncameras_intrinsics
        if s.do_optimize_extrinsics:
            parts += ([SCALE_ROTATION_CAMERA] * 3 +
                      [SCALE_TRANSLATION_CAMERA] * 3) * self.Ncameras_extrinsics
        if s.do_optimize_frames:
            parts += ([SCALE_ROTATION_FRAME] * 3 +
                      [SCALE_TRANSLATION_FRAME] * 3) * self.Nframes
            parts += [SCALE_POSITION_POINT] * (3 * self.Npoints_variable)
        if self.has_calobject_warp:
            parts += [SCALE_CALOBJECT_WARP] * 2
        return np.asarray(parts, dtype=np.float64)


# ----------------------------------------------------------------------------
# building a spec from mrcal-style optimization_inputs kwargs
# ----------------------------------------------------------------------------

_RENAMED_KWARGS = (("rt_cam_ref", "extrinsics_rt_fromref"),
                   ("rt_ref_frame", "frames_rt_toref"))


def normalize_inputs(kw):
    """Accept both mrcal>=2.5 names (rt_cam_ref, rt_ref_frame) and the
    legacy names (extrinsics_rt_fromref, frames_rt_toref).  Internally the
    legacy names are used.  Returns a new dict."""
    kw = dict(kw)
    for new, old in _RENAMED_KWARGS:
        if new in kw:
            if kw.get(old) is not None and kw[new] is not None \
                    and kw[old] is not kw[new]:
                raise ValueError(f"Both '{new}' and '{old}' given")
            if kw.get(old) is None:
                kw[old] = kw.pop(new)
            else:
                kw.pop(new)
    return kw


def _selections_from_kwargs(kw):
    return ProblemSelections(
        do_optimize_intrinsics_core=kw.get("do_optimize_intrinsics_core", True),
        do_optimize_intrinsics_distortions=kw.get(
            "do_optimize_intrinsics_distortions", True),
        do_optimize_extrinsics=kw.get("do_optimize_extrinsics", True),
        do_optimize_frames=kw.get("do_optimize_frames", True),
        do_optimize_calobject_warp=kw.get("do_optimize_calobject_warp", True),
        do_apply_regularization=kw.get("do_apply_regularization", True),
        do_apply_outlier_rejection=kw.get("do_apply_outlier_rejection", True),
        do_apply_regularization_unity_cam01=kw.get(
            "do_apply_regularization_unity_cam01", False),
    )


def _shape0(a):
    return 0 if a is None else int(np.asarray(a).shape[0])


def _triangulated_set_sizes(indices_point_triangulated):
    """Sets of observations of one triangulated point, delimited by the
    ipoint column of the index array: consecutive rows with the same ipoint
    form one set."""
    if indices_point_triangulated is None:
        return ()
    ipt = np.asarray(indices_point_triangulated)[:, 0]
    sizes = []
    n = 0
    for i in range(len(ipt)):
        n += 1
        if i == len(ipt) - 1 or ipt[i + 1] != ipt[i]:
            sizes.append(n)
            n = 0
    for s in sizes:
        if s < 2:
            raise ValueError(
                "each triangulated point must be observed at least twice")
    return tuple(sizes)


def triangulated_pair_indices(set_sizes):
    """Static (i0, i1) observation-index pairs for every pairwise
    measurement, in the reference's order (outer i0, inner i1 within a
    set)."""
    i0s, i1s = [], []
    base = 0
    for n in set_sizes:
        for a in range(n):
            for b in range(a + 1, n):
                i0s.append(base + a)
                i1s.append(base + b)
        base += n
    return np.asarray(i0s, np.int64), np.asarray(i1s, np.int64)


def spec_from_inputs(**kw):
    """Build a ProblemSpec from mrcal-style optimization_inputs kwargs."""
    kw = normalize_inputs(kw)
    lensmodel = parse_lensmodel(kw["lensmodel"])
    intrinsics = np.asarray(kw["intrinsics"])
    obs_board = kw.get("observations_board")
    Nobs_board = _shape0(obs_board)
    if Nobs_board:
        H, W = np.asarray(obs_board).shape[-3:-1]
    else:
        H = W = 0
    imagersizes = kw.get("imagersizes")
    if imagersizes is None:
        imagersizes = ()
    else:
        imagersizes = tuple(map(tuple, np.asarray(imagersizes).tolist()))
    return ProblemSpec(
        lensmodel=lensmodel,
        Ncameras_intrinsics=intrinsics.shape[0],
        Ncameras_extrinsics=_shape0(kw.get("extrinsics_rt_fromref")),
        Nframes=_shape0(kw.get("frames_rt_toref")),
        Npoints=_shape0(kw.get("points")),
        Npoints_fixed=int(kw.get("Npoints_fixed", 0)),
        Nobservations_board=Nobs_board,
        Nobservations_point=_shape0(kw.get("observations_point")),
        triangulated_set_sizes=_triangulated_set_sizes(
            kw.get("indices_point_triangulated_camintrinsics_camextrinsics")),
        calibration_object_width_n=W,
        calibration_object_height_n=H,
        calibration_object_spacing=float(
            kw.get("calibration_object_spacing", 0.0) or 0.0),
        imagersizes=imagersizes,
        selections=_selections_from_kwargs(kw),
    )


# ----------------------------------------------------------------------------
# mrcal-compatible functional API
# ----------------------------------------------------------------------------

def num_states(**kw):
    return spec_from_inputs(**kw).Nstate


def num_states_intrinsics(**kw):
    return spec_from_inputs(**kw).num_states_intrinsics


def num_states_extrinsics(**kw):
    return spec_from_inputs(**kw).num_states_extrinsics


def num_states_frames(**kw):
    return spec_from_inputs(**kw).num_states_frames


def num_states_points(**kw):
    return spec_from_inputs(**kw).num_states_points


def num_states_calobject_warp(**kw):
    return spec_from_inputs(**kw).num_states_calobject_warp


def state_index_intrinsics(icam_intrinsics, **kw):
    spec = spec_from_inputs(**kw)
    if spec.Nintrinsics_state_per_cam == 0:
        return None
    return (spec.state_index_intrinsics0
            + icam_intrinsics * spec.Nintrinsics_state_per_cam)


def state_index_extrinsics(icam_extrinsics, **kw):
    spec = spec_from_inputs(**kw)
    if not spec.selections.do_optimize_extrinsics:
        return None
    return spec.state_index_extrinsics0 + 6 * icam_extrinsics


def state_index_frames(iframe, **kw):
    spec = spec_from_inputs(**kw)
    if not spec.selections.do_optimize_frames or spec.Nframes == 0:
        return None
    return spec.state_index_frames0 + 6 * iframe


def state_index_points(i_point, **kw):
    spec = spec_from_inputs(**kw)
    if not spec.selections.do_optimize_frames or spec.Npoints_variable <= 0:
        return None
    return spec.state_index_points0 + 3 * i_point


def state_index_calobject_warp(**kw):
    spec = spec_from_inputs(**kw)
    if not spec.has_calobject_warp:
        return None
    return spec.state_index_calobject_warp0


def num_measurements(**kw):
    return spec_from_inputs(**kw).Nmeasurements


def num_measurements_boards(**kw):
    return spec_from_inputs(**kw).num_measurements_boards


def num_measurements_points(**kw):
    return spec_from_inputs(**kw).num_measurements_points


def num_measurements_points_triangulated(**kw):
    return spec_from_inputs(**kw).num_measurements_points_triangulated


def num_measurements_regularization(**kw):
    return spec_from_inputs(**kw).num_measurements_regularization


def measurement_index_boards(i_observation_board, **kw):
    spec = spec_from_inputs(**kw)
    Npts = spec.calibration_object_width_n * spec.calibration_object_height_n
    return spec.measurement_index_boards0 + i_observation_board * Npts * 2


def measurement_index_points(i_observation_point, **kw):
    spec = spec_from_inputs(**kw)
    return spec.measurement_index_points0 + 2 * i_observation_point


def measurement_index_regularization(**kw):
    return spec_from_inputs(**kw).measurement_index_regularization0


def measurement_index_points_triangulated(i_point_triangulated=0, **kw):
    """Start of the triangulated-point measurements in the measurement
    vector.  i_point_triangulated indexes SETS (points)."""
    spec = spec_from_inputs(**kw)
    off = spec.measurement_index_points_triangulated0
    for i, n in enumerate(spec.triangulated_set_sizes):
        if i >= i_point_triangulated:
            break
        off += n * (n - 1) // 2
    return off


def decode_observation_indices_points_triangulated(**kw):
    """Decode the triangulated-point observation indices into per-set
    bookkeeping: a list of dicts with iobservation0/Nobservations/
    imeasurement0/Nmeasurements per set."""
    spec = spec_from_inputs(**kw)
    out = []
    iobs = 0
    imeas = spec.measurement_index_points_triangulated0
    for n in spec.triangulated_set_sizes:
        npairs = n * (n - 1) // 2
        out.append(dict(iobservation0=iobs, Nobservations=n,
                        imeasurement0=imeas, Nmeasurements=npairs))
        iobs += n
        imeas += npairs
    return out
