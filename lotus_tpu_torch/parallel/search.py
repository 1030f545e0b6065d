"""Sharded exact search: per-rank top-k, then an all-gather merge.

Port of ``lotus_tpu/parallel/search.py``.  Each rank scans only its row
shard with the single-device ``flat_search`` (``ops/flat.py``), makes its k
candidates' ids global, and the (B, k) candidates of all ranks are
all-gathered, so every rank computes the same final merge.
"""

from __future__ import annotations

from typing import Optional

import torch

from lotus_tpu_torch.ops.common import MASK_SCORE, NO_HIT, as_distance, as_similarity, check_metric
from lotus_tpu_torch.ops.flat import DEFAULT_BLOCK_ROWS, flat_search
from lotus_tpu_torch.parallel.ivf import merge_shard_topk
from lotus_tpu_torch.parallel.mesh import SHARD_AXIS, ShardMesh


def sharded_flat_search(
    xb_local: torch.Tensor,
    xq: torch.Tensor,
    k: int,
    *,
    n_rows: int,
    metric: str = "ip",
    valid: Optional[torch.Tensor] = None,
    mesh: Optional[ShardMesh] = None,
    axis_name: str = SHARD_AXIS,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    approx: bool = False,
    xb_scales: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a row-sharded database.

    Args:
        xb_local: this rank's (N_pad / size, d) rows, as
            :func:`lotus_tpu_torch.parallel.shard_rows` gives them.
        xq: (B, d) queries, the same on every rank.
        n_rows: logical row count (padding rows are masked out).
        valid: optional subset mask of this rank's rows, sharded like xb.
        xb_scales: this rank's per-row factors of an int8 database.

    Returns:
        (distances, indices) of shape (B, k), the same on every rank;
        indices are global row ids, -1 for missing hits.
    """
    check_metric(metric)
    if mesh is None:
        raise ValueError("mesh is required")
    rows_per_shard = xb_local.shape[0]
    squeeze = xq.ndim == 1
    if squeeze:
        xq = xq[None, :]
    xq = xq.to(xb_local.device)

    # Rows beyond the logical count are masked via n_rows relative to this
    # shard's offset.
    row_offset = mesh.slot * rows_per_shard
    local_n = min(max(int(n_rows) - row_offset, 0), rows_per_shard)
    dists, idx = flat_search(
        xb_local, xq, k, metric=metric, n_rows=local_n, valid=valid, block_rows=block_rows,
        approx=approx, xb_scales=xb_scales,
    )
    scores = as_similarity(dists, metric)
    scores = torch.where(idx == NO_HIT, torch.full_like(scores, MASK_SCORE), scores)
    gidx = torch.where(idx == NO_HIT, idx, idx + row_offset)
    top_s, top_i = merge_shard_topk(mesh, scores, gidx, k, dedup=False)

    # flat_search returned whole metric-convention distances (with the
    # +||q||^2 term for l2), so converting back is exact.
    out = as_distance(top_s, metric)
    if metric == "l2":
        out = torch.where(top_i == NO_HIT, torch.finfo(torch.float32).max, out)
    if squeeze:
        return out[0], top_i[0]
    return out, top_i
