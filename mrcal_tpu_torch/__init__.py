"""mrcal_tpu_torch — the PyTorch/CUDA port of mrcal_tpu.

A second package beside the JAX one, held against it number for number.
It covers parametric chessboard, discrete-point and triangulated-point
calibrations solved end to end: layout and packing, the projection chain
and its inverse, two-view triangulation, the normal equations, the Schur
step with its hand-written Hopper batched-Cholesky kernel (``ops/``), the
LM loop, ``optimize()`` (with ``check_gradient``), batched solves
(``optimize_batch``, ``pad_problems_to_common_structure``),
``optimizer_callback`` with its sparse Jacobian, the pose functions,
``project``/``unproject``, ``cameramodel`` (with the JPL .cahvor format),
``CHOLMOD_factorization``, the uncertainty of a calibration
(``projection_uncertainty``, ``projection_diff`` and the rest of
``model_analysis``), ``triangulate`` with the uncertainty of its points,
the synthetic scenes of ``synthetic_data``, the helpers of ``utils``, the
calibration front end: image files (``image``), chessboard detection
(``detector``) and the seed of a calibration (``calibration``), and dense
stereo: image reprojection between lens models (``image_transforms``),
rectification, ranging, feature and block matching (``stereo``) and
census + semi-global matching (``stereo_sgm``), and the plots of a
calibration (``visualization``: each ``show_*`` computes its arrays on the
device and draws them with matplotlib, imported only then).  Every lens
model of the JAX package projects: the parametric ones, CAHVOR, CAHVORE and
the splined one.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``.  Everything is float64 unless a caller asks for float32,
or the JAX package works in float32 (the rectification maps, the census,
SGM and NCC matchers).
"""

from . import _config  # noqa: F401  — TF32 off before any product runs

from .calibration import (  # noqa: F401
    compute_chessboard_corners,
    estimate_joint_frame_poses,
    estimate_monocular_calobject_poses_Rt_tocam,
    seed_stereographic,
    traverse_sensor_links,
)

from .cameramodel import CameramodelParseException, cameramodel  # noqa: F401
from .detector import (  # noqa: F401
    chess_response,
    detect_corners_in_images,
    find_chessboard_corners,
)
from .factorization import CHOLMOD_factorization  # noqa: F401
from .image import apply_color_map, load_image, save_image  # noqa: F401
from .image_transforms import (  # noqa: F401
    image_transformation_map,
    pinhole_model_for_reprojection,
    scale_focal__best_pinhole_fit,
    transform_image,
)
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
from .stereo import (  # noqa: F401
    match_feature,
    rectification_maps,
    rectified_resolution,
    rectified_system,
    stereo_matching_ncc,
    stereo_range,
    stereo_unproject,
)
from .stereo_sgm import stereo_matching_sgm  # noqa: F401
from .synthetic_data import (  # noqa: F401
    make_perfect_observations,
    make_tracks,
    ref_calibration_object,
    synthesize_board_observations,
)
from .triangulation import (  # noqa: F401
    triangulate,
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
    apply_homography,
    close_contour,
    hypothesis_board_corner_positions,
    ingest_packed_state,
    mapping_file_framenocameraindex,
    measurements_board,
    measurements_point,
    plotoptions_measurement_boundaries,
    plotoptions_state_boundaries,
    polygon_difference,
    residuals_board,
    residuals_point,
    sample_imager,
    sample_imager_unproject,
    sorted_eig,
    write_point_cloud_as_ply,
)
from .visualization import (  # noqa: F401
    annotate_image__valid_intrinsics_region,
    fitted_gaussian_equation,
    imagergrid_using,
    show_distortion_off_pinhole,
    show_distortion_off_pinhole_radial,
    show_geometry,
    show_projection_diff,
    show_projection_uncertainty,
    show_projection_uncertainty_vs_distance,
    show_residuals_board_observation,
    show_residuals_directions,
    show_residuals_histogram,
    show_residuals_magnitudes,
    show_residuals_regional,
    show_residuals_vectorfield,
    show_splined_model_correction,
    show_stereo_pair_diff,
    show_valid_intrinsics_region,
)
from .cahvor import read_transforms  # noqa: F401
