"""On-disk index format: raw little-endian ``.npy`` arrays + a JSON manifest.

The same format as ``lotus_tpu/ops/io.py``, so an index directory written by
one package loads in the other:

    index_dir/
      meta.json          — manifest: format version, shapes, dtype, metric,
                           index kind and kind-specific metadata
      vectors.npy        — (N, d) embeddings (original row order)
      <extra>.npy        — kind-specific arrays (centroids, list offsets, ...)
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

FORMAT_VERSION = 1
META_FILE = "meta.json"


def write_meta(index_dir: str, meta: dict[str, Any]) -> None:
    os.makedirs(index_dir, exist_ok=True)
    meta = dict(meta)
    meta["format_version"] = FORMAT_VERSION
    with open(os.path.join(index_dir, META_FILE), "w") as f:
        json.dump(meta, f, indent=2, default=str)


def read_meta(index_dir: str) -> dict[str, Any]:
    path = os.path.join(index_dir, META_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(f"No index manifest at {path}")
    with open(path) as f:
        meta = json.load(f)
    if meta.get("format_version", 0) > FORMAT_VERSION:
        raise ValueError(
            f"Index at {index_dir} has format_version {meta['format_version']}; "
            f"this build reads up to {FORMAT_VERSION}"
        )
    return meta


def write_array(index_dir: str, name: str, arr: np.ndarray) -> None:
    os.makedirs(index_dir, exist_ok=True)
    np.save(os.path.join(index_dir, f"{name}.npy"), arr)


def read_array(index_dir: str, name: str, mmap: bool = True) -> np.ndarray:
    path = os.path.join(index_dir, f"{name}.npy")
    return np.load(path, mmap_mode="r" if mmap else None)


def has_shard_manifest(index_dir: str) -> bool:
    """True when the index was also persisted as per-host shards
    (``parallel/distributed.py``'s ``shards.json`` lives beside meta.json)."""
    from lotus_tpu_torch.parallel.distributed import SHARD_MANIFEST

    return os.path.exists(os.path.join(index_dir, SHARD_MANIFEST))

