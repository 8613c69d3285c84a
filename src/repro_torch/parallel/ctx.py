"""Parallelism context threaded through the model forwards.

The reference's ``ParallelCtx`` names a ``jax.sharding.Mesh``; here
``mesh`` is a :class:`Mesh`, a ``torch.distributed`` process group with the
reference mesh's named axis sizes (``shape``), so the spec logic of
:mod:`repro_torch.parallel.rules` reads ``mesh.shape[axis]`` as the
reference's does.  Every rank of the group runs the same program (SPMD);
``rank`` and ``world`` are this process's place on the ``model`` axis
(all that serving reads), ``dp_rank`` and ``dp_world`` its place on the
data axis (what the trainer reads).

``align`` and ``layout`` have no reference counterpart: GSPMD decides
per array how to run a sharded product, while here each rank holds a
local slice and the placement must keep whole heads and whole
quantization groups on one rank.  ``align`` is the multiple of input
features a column slice must keep (the policies' group sizes and codes
per word); ``layout`` (:class:`~repro_torch.parallel.rules.TPLayout`) is
the per-block decision :func:`~repro_torch.parallel.rules.bind` takes once
per model, which placement, the model code and the requant all read.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A process group with named axis sizes.  ``group`` is the
    ``torch.distributed`` group (None for a shape-only mesh, which the
    placement rules accept and no collective does); ``backend`` is
    ``"nccl"`` or ``"gloo"``; ``stage`` is True when the backend cannot
    take the device's tensors itself (gloo with CUDA tensors), so every
    collective goes through a pinned host buffer
    (:mod:`repro_torch.parallel.comm`); ``rank`` is this process's rank in
    ``group``.  ``dp_group`` and ``dp_rank`` are the same for the data
    axis: the ranks that hold the same model slice (None and 0 when the
    data axis has one rank)."""
    group: Any = None
    shape: Any = None                  # {"data": d, "model": m}
    axis_names: Tuple[str, ...] = ("data", "model")
    backend: str = "gloo"
    device: str = "cpu"
    stage: bool = False
    rank: int = 0
    dp_group: Any = None
    dp_rank: int = 0

    def __post_init__(self):
        if self.shape is None:
            object.__setattr__(self, "shape", {"data": 1, "model": 1})


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    mesh: Optional[Mesh] = None
    data_axes: Tuple[str, ...] = ("data",)     # batch axes
    model_axis: str = "model"
    moe_impl: str = "a2a"                      # 'a2a' (EP) | 'dense'
    seq_axis: Optional[str] = None             # SP: shard sequence on this axis
    align: int = 1                             # input features per column slice
    layout: Any = None                         # rules.TPLayout once bound

    @property
    def dp(self):
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]

    @property
    def world(self) -> int:
        """Ranks on the model axis (1 without a mesh)."""
        return 1 if self.mesh is None else int(
            self.mesh.shape.get(self.model_axis, 1))

    @property
    def rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.rank

    @property
    def dp_world(self) -> int:
        """Ranks on the data axes (1 without a mesh)."""
        if self.mesh is None:
            return 1
        n = 1
        for a in self.data_axes:
            n *= int(self.mesh.shape.get(a, 1))
        return n

    @property
    def dp_rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.dp_rank
