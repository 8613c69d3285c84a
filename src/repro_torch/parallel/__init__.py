"""Tensor and data parallelism over ``torch.distributed``: the parallel
context, the placement rules and the collectives.

The exports are the reference's (``repro.parallel``) but for
``shard_map``, which has no PyTorch counterpart: a process per rank runs
the model on its local slices, and the wrappers of
:mod:`repro_torch.kernels.ops` (``*_tp``) run the collectives
themselves.
"""
from .ctx import Mesh, ParallelCtx
from .rules import (NamedSharding, param_sharding, shard_params,
                    state_sharding)

__all__ = ["Mesh", "NamedSharding", "ParallelCtx", "param_sharding",
           "shard_params", "state_sharding"]
