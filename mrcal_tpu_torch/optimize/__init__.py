"""Optimization core of the port: layout, residuals, the Schur-reduced
Levenberg-Marquardt solver and the sparse measurement Jacobian
(counterpart of ``mrcal_tpu.optimize``)."""

from .layout import (  # noqa: F401
    ProblemSelections,
    ProblemSpec,
    spec_from_inputs,
    num_states,
    num_states_intrinsics, num_states_extrinsics, num_states_frames,
    num_states_points, num_states_calobject_warp,
    state_index_intrinsics, state_index_extrinsics, state_index_frames,
    state_index_points, state_index_calobject_warp,
    num_measurements,
    num_measurements_boards, num_measurements_points,
    num_measurements_points_triangulated,
    num_measurements_regularization,
    measurement_index_boards, measurement_index_points,
    measurement_index_points_triangulated,
    measurement_index_regularization,
    decode_observation_indices_points_triangulated,
)
from .jacobian import optimizer_callback  # noqa: F401
from .solver import (  # noqa: F401
    optimize, optimize_batch, pad_problems_to_common_structure)
