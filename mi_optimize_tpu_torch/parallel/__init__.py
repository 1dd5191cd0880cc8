"""Tensor and data parallelism on torch.distributed: port of
mi_optimize_tpu/parallel (sharding, collectives, launch, the overlapped
ring dequant matmul) and the torch twin of __graft_entry__.dryrun_multichip
(`dryrun`)."""
from . import launch  # noqa: F401
from .collectives import (  # noqa: F401
    LocalGroup, all_gather, all_reduce, row_parallel_matmul, sharded_absmax, sharded_xtx,
)
from .sharding import (  # noqa: F401
    LINEAR_KIND, cache_shard, make_mesh, rank_config, shard_model, shard_params, tp_group,
)
