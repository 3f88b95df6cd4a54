"""Multi-chip parallelism: vmapped scene batching (data-parallel) and
shard_map spatial domain decomposition (the SPH analogue of
sequence/context parallelism).

The reference is single-process single-GPU (SURVEY.md §2: no DP/TP/PP/SP of
any kind); these modules are the scaling story it never had, built on
jax.sharding.Mesh + XLA collectives (NCCL between GPUs).
"""

from .batch import BatchedScenes, batch_configs, make_batched_step  # noqa: F401
from .domain import (  # noqa: F401
    make_batched_sharded_step,
    make_sharded_frame_step,
    shard_state,
)
