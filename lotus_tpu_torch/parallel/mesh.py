"""Shard meshes on ``torch.distributed`` and row sharding.

Port of ``lotus_tpu/parallel/mesh.py``.  A JAX mesh is a grid of devices
that one ``shard_map`` program spans; here a mesh slot is a rank of a
process group, and the body of the reference's ``shard_map`` is what each
rank runs (SPMD: every rank calls the sharded functions with the same
replicated arguments and gets the same replicated result).  Each rank holds
its own shard on its own ``torch.device``.

The collectives are ``dist.all_gather`` in its list form (it runs under
gloo and NCCL alike) for ``jax.lax.all_gather``, and ``dist.all_reduce``
for ``jax.lax.psum``.  gloo takes CUDA tensors for both (it copies them
through the host itself), so several ranks can share one card.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Optional

import torch
import torch.distributed as dist

from lotus_tpu_torch.ops.common import round_up

SHARD_AXIS = "shard"


@dataclass
class ShardMesh:
    """A 1-D mesh (or a 2-D ``(host, shard)`` one from ``hybrid_mesh``) of
    ranks.

    ``group``: the process group (None for a single process); ``order``: the
    group ranks in mesh order, so slot ``i`` is group rank ``order[i]``;
    ``slot``: this rank's place in that order; ``device``: where this rank's
    shard lives.  ``axis_names`` and ``dims`` give the mesh's shape: the
    product of ``dims`` is the number of slots.
    """

    group: Optional[Any]
    order: list[int]
    slot: int
    device: torch.device
    axis_names: tuple[str, ...] = (SHARD_AXIS,)
    dims: tuple[int, ...] = field(default=())

    def __post_init__(self) -> None:
        self.device = torch.device(self.device)
        if not self.dims:
            self.dims = (len(self.order),)
        if len(self.axis_names) != len(self.dims):
            raise ValueError(f"axis_names {self.axis_names} do not match dims {self.dims}")
        n = 1
        for dim in self.dims:
            n *= dim
        if n != len(self.order):
            raise ValueError(f"dims {self.dims} hold {n} slots; order has {len(self.order)}")

    @property
    def size(self) -> int:
        """Number of slots (ranks) in the mesh."""
        return len(self.order)

    @property
    def shape(self) -> dict[str, int]:
        """Slots along each axis, as ``jax.sharding.Mesh.shape``; a 1-D view
        of a 2-D mesh is ``flat``."""
        return dict(zip(self.axis_names, self.dims))

    def flat(self, axis_name: str = SHARD_AXIS) -> "ShardMesh":
        """The same ranks in the same order along one axis."""
        return ShardMesh(self.group, list(self.order), self.slot, self.device, (axis_name,))

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``(size, *t.shape)``: every slot's ``t``, in mesh order, on every rank."""
        if self.size == 1:
            return t[None]
        src = t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.stack([parts[r] for r in self.order])

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every slot's ``t`` (a new tensor; ``t`` is left as it is)."""
        out = t.clone()
        if self.size > 1:
            dist.all_reduce(out, group=self.group)
        return out

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group)


def rank_device() -> torch.device:
    """The card of this rank: ``cuda:{LOCAL_RANK % device_count}``.  There is
    no CPU default: without a card it raises (pass ``device="cpu"`` to the
    mesh builders to run on the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError('lotus_tpu_torch: no CUDA device; pass device="cpu" to run on the CPU')
    return torch.device(f"cuda:{int(os.environ.get('LOCAL_RANK', '0')) % torch.cuda.device_count()}")


def default_mesh(
    n_devices: Optional[int] = None,
    axis_name: str = SHARD_AXIS,
    *,
    device: torch.device | str | None = None,
) -> Optional[ShardMesh]:
    """1-D mesh over every rank of the default group (or the first
    ``n_devices``; a single process is a mesh of one).

    With ``n_devices`` below the world size every rank must call this, as
    ``dist.new_group`` asks; ranks outside the first ``n_devices`` get None.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"n_devices={n_devices} outside 1..{world} ranks")
    group = None
    if n < world:
        group = dist.new_group(list(range(n)))
    elif world > 1:
        group = dist.group.WORLD
    if rank >= n:
        return None
    dev = torch.device(device) if device is not None else rank_device()
    return ShardMesh(group, list(range(n)), rank, dev, (axis_name,))


def shard_rows(
    x: torch.Tensor,
    mesh: ShardMesh,
    *,
    axis_name: str = SHARD_AXIS,
    block_rows: int = 1,
) -> tuple[torch.Tensor, int]:
    """Pad x's rows so each shard is a whole multiple of ``block_rows``, and
    keep this rank's slice on its device.

    Returns (this rank's rows, logical row count).  Slot ``i`` holds padded
    rows ``[i * n_pad / size, (i + 1) * n_pad / size)``, as the reference's
    ``P(axis_name)`` placement does.
    """
    n = x.shape[0]
    n_dev = mesh.shape[axis_name]
    n_pad = round_up(max(n, n_dev * block_rows), n_dev * block_rows)
    per = n_pad // n_dev
    lo = mesh.slot * per
    part = x[lo : min(lo + per, n)]
    if part.shape[0] < per:
        pad = torch.zeros((per - part.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
        part = torch.cat([part, pad])
    return part.to(mesh.device), n
