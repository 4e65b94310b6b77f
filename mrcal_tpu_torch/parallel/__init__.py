"""Multi-device solves of the port: the observation axis sharded over a
torch.distributed process group (counterpart of ``mrcal_tpu.parallel``)."""

from .sharding import (  # noqa: F401
    Mesh,
    collective_bytes_per_iteration,
    dryrun_multichip,
    make_mesh,
    sharded_lm_solve,
    sharded_lm_solve_device,
    sharded_lm_step,
    sharded_normal_equations,
    spawn,
)
