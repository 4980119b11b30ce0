from agrl_torch.parallel.mesh import (
    Mesh,
    all_reduce_mean,
    average_gradients,
    gather_rows,
    initialize_distributed,
    make_mesh,
    replicated,
    shard_batch,
    torchrun_environment,
)

__all__ = [
    "Mesh",
    "all_reduce_mean",
    "average_gradients",
    "gather_rows",
    "initialize_distributed",
    "make_mesh",
    "replicated",
    "shard_batch",
    "torchrun_environment",
]
