"""mrcal_tpu_torch — the PyTorch/CUDA port of mrcal_tpu.

A second package beside the JAX one, held against it number for number.
It covers parametric chessboard, discrete-point and triangulated-point
calibrations solved end to end: layout and packing, the projection chain
and its inverse, two-view triangulation, the normal equations, the Schur
step with its hand-written Hopper batched-Cholesky kernel (``ops/``), the
LM loop, ``optimize()`` (with ``check_gradient``), batched solves
(``optimize_batch``, ``pad_problems_to_common_structure``),
``optimizer_callback`` with its sparse Jacobian, the pose functions,
``project``/``unproject``, ``cameramodel``, ``CHOLMOD_factorization`` and
the uncertainty of a calibration (``projection_uncertainty``,
``projection_diff`` and the rest of ``model_analysis``).

Entry points run on the CUDA card unless the caller passes
``device="cpu"``.  Everything is float64 unless a caller asks for float32.
"""

from . import _config  # noqa: F401  — TF32 off before any product runs

from .cameramodel import CameramodelParseException, cameramodel  # noqa: F401
from .factorization import CHOLMOD_factorization  # noqa: F401
from .lensmodels import (  # noqa: F401
    knots_for_splined_models,
    lensmodel_metadata_and_config,
    lensmodel_num_params,
    project_core,
    supported_lensmodels,
    unproject_core,
)
from .model_analysis import (  # noqa: F401
    implied_Rt10__from_unprojections,
    is_within_valid_intrinsics_region,
    model_resolution__deg_pixel,
    projection_diff,
    projection_uncertainty,
    stereo_pair_diff,
    worst_direction_stdev,
)
from .optimize import (  # noqa: F401
    camera_extrinsics_indices,
    corresponding_icam_extrinsics,
    decode_observation_indices_points_triangulated,
    drt_cross_reprojection__dbpacked,
    measurement_index_boards, measurement_index_points,
    measurement_index_points_triangulated,
    measurement_index_regularization,
    num_intrinsics_optimization_params,
    num_measurements, num_measurements_boards, num_measurements_points,
    num_measurements_points_triangulated, num_measurements_regularization,
    num_states, num_states_calobject_warp, num_states_extrinsics,
    num_states_frames, num_states_intrinsics, num_states_points,
    optimize, optimize_batch, optimizer_callback, pack_state,
    pad_problems_to_common_structure,
    state_index_calobject_warp, state_index_extrinsics, state_index_frames,
    state_index_intrinsics, state_index_points,
    unpack_state,
)
from .poseutils import *  # noqa: F401,F403
from .projections import (  # noqa: F401
    project, project_latlon, project_lonlat, project_pinhole,
    project_stereographic, unproject, unproject_latlon, unproject_lonlat,
    unproject_pinhole, unproject_stereographic,
)
from .triangulation import (  # noqa: F401
    triangulate_geometric,
    triangulate_leecivera_l1,
    triangulate_leecivera_linf,
    triangulate_leecivera_mid2,
    triangulate_leecivera_wmid2,
    triangulate_lindstrom,
)
from .utils import (  # noqa: F401
    align_procrustes_points_Rt01,
    align_procrustes_vectors_R01,
    sample_imager,
    sample_imager_unproject,
)
