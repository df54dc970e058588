"""The (data, model) mesh of ranks, the sharding rules and their collectives."""

from gemm_gan_tpu_torch.parallel.mesh import distributed_init, make_mesh  # noqa: F401
from gemm_gan_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_sharding,
    param_shardings,
    replicated,
)
