"""mrcal_tpu_torch — the PyTorch/CUDA port of mrcal_tpu.

A second package beside the JAX one, held against it number for number.
It covers parametric chessboard, discrete-point and triangulated-point
calibrations solved end to end: layout and packing, the projection chain
and its inverse, two-view triangulation, the normal equations, the Schur
step with its hand-written Hopper batched-Cholesky kernel (``ops/``), the
LM loop, ``optimize()`` (with ``check_gradient``), batched solves
(``optimize_batch``, ``pad_problems_to_common_structure``) and
``optimizer_callback`` with its sparse Jacobian.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``.  Everything is float64 unless a caller asks for float32.
"""

from . import _config  # noqa: F401  — TF32 off before any product runs

from .lensmodels import (  # noqa: F401
    lensmodel_metadata_and_config,
    lensmodel_num_params,
    project_core,
    unproject_core,
)
from .optimize import (  # noqa: F401
    optimize, optimize_batch, optimizer_callback,
    pad_problems_to_common_structure)
from .poseutils import (  # noqa: F401
    R_from_r,
    compose_r,
    compose_rt,
    rotate_point_R,
    rotate_point_r,
    skew_symmetric,
    transform_point_rt,
)
from .triangulation import (  # noqa: F401
    triangulate_geometric,
    triangulate_leecivera_l1,
    triangulate_leecivera_linf,
    triangulate_leecivera_mid2,
    triangulate_leecivera_wmid2,
    triangulate_lindstrom,
)
