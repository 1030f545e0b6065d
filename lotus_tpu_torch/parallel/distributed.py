"""Multi-process scaffolding: process-group start-up, host-ordered meshes
and per-host index shard persistence.

Port of ``lotus_tpu/parallel/distributed.py``:

- ``init_runtime`` starts ``torch.distributed`` from explicit arguments or
  the environment ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``,
  ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), and is a no-op for a single
  process, as the reference's is, so library code can call it always.
- ``hybrid_mesh`` orders the ranks host by host (axes ``host`` and
  ``shard``); ``serving_mesh`` is its flat view, the topology
  ``TorchVS.distributed()`` serves on.
- ``save_index_shards`` / ``load_index_shard`` / ``shard_manifest`` keep the
  reference's format (``shards.json`` format version 1,
  ``shard_<id:05d>/<name>.npy``), so a shard directory written by either
  package loads in the other.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from lotus_tpu_torch.parallel.mesh import SHARD_AXIS, ShardMesh, rank_device

SHARD_MANIFEST = "shards.json"
SHARD_FORMAT_VERSION = 1

#: Mesh axis names: hosts, then the ranks within a host.
HOST_AXIS = "host"
CHIP_AXIS = "shard"

# How long a collective may wait for the other ranks before it raises.
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


def init_runtime(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
) -> bool:
    """Start the default process group if this looks like a multi-process run.

    Sources, in order: explicit arguments (``coordinator_address`` as
    ``host:port``), then ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` /
    ``RANK``.  Returns True when a process group runs (started here or
    before), False for a plain single process (no-op).

    The backend is ``nccl`` when every local rank has a card of its own
    (``LOCAL_WORLD_SIZE`` ranks, at most ``device_count`` of them), else
    ``gloo``; ``backend`` overrides it.  Under NCCL each rank's current
    device is set to ``cuda:{LOCAL_RANK}``.
    """
    if dist.is_initialized():
        return True
    if coordinator_address is None and os.getenv("MASTER_ADDR"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    env_world = os.getenv("WORLD_SIZE")
    num_processes = num_processes if num_processes is not None else (int(env_world) if env_world else None)
    env_rank = os.getenv("RANK")
    process_id = process_id if process_id is not None else (int(env_rank) if env_rank else None)

    if coordinator_address is None and num_processes is None:
        return False  # single process; nothing to do
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("init_runtime: give the coordinator address, the process count and this process's id")
    if backend is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(num_processes)))
        own_card = dist.is_nccl_available() and 0 < local_world <= cards
        backend = "nccl" if own_card else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank_device())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes, rank=process_id,
        timeout=COLLECTIVE_TIMEOUT,
    )
    return True


def hybrid_mesh(
    host_axis: str = HOST_AXIS, chip_axis: str = CHIP_AXIS, *, device: torch.device | str | None = None
) -> ShardMesh:
    """(host, shard) mesh: ranks ordered host by host, each host's ranks by
    their local rank.

    Every rank must call it (it gathers the host names).  A single process is
    a (1, 1) mesh with the same axis names, so sharding code is agnostic of
    the host count.  ``device`` defaults to ``cuda:{LOCAL_RANK % device_count}``.
    """
    dev = torch.device(device) if device is not None else rank_device()
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return ShardMesh(None, [0], 0, dev, (host_axis, chip_axis), (1, 1))
    world, rank = dist.get_world_size(), dist.get_rank()
    mine = (socket.gethostname(), int(os.environ.get("LOCAL_RANK", "0")))
    peers: list[Any] = [None] * world
    dist.all_gather_object(peers, mine)
    hosts: list[str] = []
    for host, _ in peers:
        if host not in hosts:
            hosts.append(host)
    order = sorted(range(world), key=lambda r: (hosts.index(peers[r][0]), peers[r][1], r))
    per_host = [sum(1 for h, _ in peers if h == host) for host in hosts]
    if len(set(per_host)) != 1:
        raise ValueError(f"hybrid_mesh: hosts hold unequal rank counts {per_host}")
    return ShardMesh(dist.group.WORLD, order, order.index(rank), dev, (host_axis, chip_axis),
                     (len(hosts), per_host[0]))


def serving_mesh(axis_name: Optional[str] = None, *, device: torch.device | str | None = None) -> ShardMesh:
    """Flat 1-D mesh over every rank in ``hybrid_mesh``'s host order: index
    shards over the one axis, candidate merges all-gathered over it.  This is
    what ``TorchVS.distributed()`` builds."""
    return hybrid_mesh(device=device).flat(axis_name or SHARD_AXIS)


# ---------------------------------------------------------------------------
# Per-host shard persistence (plain numpy, as the reference's)
# ---------------------------------------------------------------------------


def _check_version(manifest: dict[str, Any]) -> None:
    if manifest.get("format_version") != SHARD_FORMAT_VERSION:
        raise ValueError(
            f"index shard manifest version {manifest.get('format_version')} "
            f"!= supported {SHARD_FORMAT_VERSION}"
        )


def save_index_shards(
    index_dir: str,
    arrays: dict[str, np.ndarray],
    *,
    shard_id: int,
    num_shards: int,
    meta: dict[str, Any] | None = None,
) -> None:
    """Write one shard's arrays plus the shared manifest.

    Layout: ``<index_dir>/shard_<id>/<name>.npy``; the manifest records the
    shard table and per-array row counts, so any host can check coverage
    before serving.
    """
    root = Path(index_dir)
    shard_dir = root / f"shard_{shard_id:05d}"
    shard_dir.mkdir(parents=True, exist_ok=True)
    rows: dict[str, int] = {}
    for name, arr in arrays.items():
        np.save(shard_dir / f"{name}.npy", np.ascontiguousarray(arr))
        rows[name] = int(arr.shape[0])

    manifest_path = root / SHARD_MANIFEST
    manifest: dict[str, Any] = {
        "format_version": SHARD_FORMAT_VERSION,
        "num_shards": num_shards,
        "shards": {},
    }
    if manifest_path.exists():
        manifest = json.loads(manifest_path.read_text())
        _check_version(manifest)
        if int(manifest.get("num_shards", num_shards)) != num_shards:
            raise ValueError("num_shards mismatch with existing manifest")
    manifest["shards"][str(shard_id)] = {"dir": shard_dir.name, "rows": rows}
    if meta is not None:
        manifest["meta"] = meta
    manifest_path.write_text(json.dumps(manifest, indent=1, sort_keys=True))


def load_index_shard(index_dir: str, shard_id: int, *, mmap: bool = True) -> dict[str, np.ndarray]:
    """Read one shard back (memory-mapped by default)."""
    root = Path(index_dir)
    manifest = json.loads((root / SHARD_MANIFEST).read_text())
    _check_version(manifest)
    entry = manifest["shards"].get(str(shard_id))
    if entry is None:
        raise FileNotFoundError(f"shard {shard_id} not present in {root / SHARD_MANIFEST}")
    shard_dir = root / entry["dir"]
    out: dict[str, np.ndarray] = {}
    for name, nrows in entry["rows"].items():
        arr = np.load(shard_dir / f"{name}.npy", mmap_mode="r" if mmap else None)
        if int(arr.shape[0]) != nrows:
            raise ValueError(f"shard {shard_id} array {name}: rows {arr.shape[0]} != manifest {nrows}")
        out[name] = arr
    return out


def shard_manifest(index_dir: str) -> dict[str, Any]:
    """The parsed shard manifest (for coverage checks before serving)."""
    return json.loads((Path(index_dir) / SHARD_MANIFEST).read_text())
