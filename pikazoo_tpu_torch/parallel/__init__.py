"""Data parallelism over the env batch: the process group as a one-axis mesh."""

from pikazoo_tpu_torch.parallel.mesh import (EnvMesh, all_reduce_sum, barrier, gather_batch,
                                             init_distributed, make_env_mesh, replicated,
                                             shard_batch)

__all__ = [
    "EnvMesh",
    "init_distributed",
    "make_env_mesh",
    "shard_batch",
    "gather_batch",
    "replicated",
    "all_reduce_sum",
    "barrier",
]
