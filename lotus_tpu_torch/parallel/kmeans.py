"""Sharded Lloyd's k-means: local (sums, counts) summed over the mesh.

Port of ``lotus_tpu/parallel/kmeans.py``.  Data rows are sharded over the
ranks; every rank keeps its own copy of the centroids, assigns its rows
(blocked scores + argmax) and contributes per-centroid partial sums that
``all_reduce`` adds up, as the reference's ``psum`` does.  The update rule
and the empty-cluster rule are the reference's.
"""

from __future__ import annotations

from typing import Optional

import torch

from lotus_tpu_torch.ops.common import check_metric, l2_normalize
from lotus_tpu_torch.ops.kmeans import KMeansResult, _c_norms, _scores
from lotus_tpu_torch.parallel.mesh import SHARD_AXIS, ShardMesh


def _local_stats(x_local, centroids, n_local, k, metric, block_rows):
    """Blocked assignment of this rank's first ``n_local`` rows ->
    (sums (k, d), counts (k,), score_sum ()) in f32."""
    d = x_local.shape[1]
    dev = x_local.device
    c_norms = _c_norms(centroids)
    sums = torch.zeros((k, d), dtype=torch.float32, device=dev)
    counts = torch.zeros((k,), dtype=torch.float32, device=dev)
    score_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for lo in range(0, n_local, block_rows):
        block = x_local[lo : min(lo + block_rows, n_local)]
        best_score, best = torch.max(_scores(block, centroids, metric, c_norms), dim=1)
        sums.index_add_(0, best, block.float())
        counts.index_add_(0, best, torch.ones_like(best_score))
        score_sum = score_sum + torch.sum(best_score)
    return sums, counts, score_sum


def lloyd_step(x_local, centroids, *, n_local, k, metric, mesh, spherical=False, block_rows=16384):
    """One sharded Lloyd step: the summed (sums, counts, score_sum) and the
    new centroids (empty clusters keep their centroid)."""
    sums, counts, score_sum = _local_stats(x_local, centroids, n_local, k, metric, block_rows)
    sums, counts, score_sum = mesh.all_reduce(sums), mesh.all_reduce(counts), mesh.all_reduce(score_sum)
    c32 = centroids.float()
    new_c = sums / torch.clamp(counts[:, None], min=1.0)
    new_c = torch.where(counts[:, None] > 0, new_c, c32)
    if spherical:
        new_c = l2_normalize(new_c)
    return (sums, counts, score_sum), new_c


def sharded_kmeans_fit(
    x_local: torch.Tensor,
    k: int,
    *,
    n_rows: int,
    mesh: ShardMesh,
    iters: int = 20,
    metric: str = "l2",
    seed: int = 0,
    spherical: bool = False,
    axis_name: str = SHARD_AXIS,
    block_rows: int = 16384,
    init_centroids: Optional[torch.Tensor] = None,
) -> KMeansResult:
    """Train k-means over a row-sharded dataset.

    ``x_local``: this rank's rows, as ``shard_rows`` gives them; ``n_rows``:
    the logical row count (padding is masked out).  Init samples k distinct
    logical rows with a ``torch.Generator`` seeded with ``seed`` on every
    rank (the reference's ``jax.random.choice`` draws other rows), unless
    ``init_centroids`` are given.  Returns replicated centroids, the
    assignments of all ``n_rows`` rows and the inertia.
    """
    check_metric(metric)
    rows_per_shard, d = x_local.shape
    dev = x_local.device
    offset = mesh.slot * rows_per_shard
    n_local = min(max(n_rows - offset, 0), rows_per_shard)

    if init_centroids is None:
        # Every rank draws the same k rows; each fills in the ones it holds,
        # and the sum over the mesh assembles them (exactly: one term each).
        g = torch.Generator().manual_seed(seed)
        pick = torch.sort(torch.randperm(n_rows, generator=g)[:k]).values.to(dev)
        mine = (pick >= offset) & (pick < offset + n_local)
        part = torch.zeros((k, d), dtype=torch.float32, device=dev)
        part[mine] = x_local[pick[mine] - offset].float()
        init_centroids = mesh.all_reduce(part)
        if spherical:
            init_centroids = l2_normalize(init_centroids)
    centroids = init_centroids.float().to(dev)

    for _ in range(iters):
        _, centroids = lloyd_step(x_local, centroids, n_local=n_local, k=k, metric=metric, mesh=mesh,
                                  spherical=spherical, block_rows=block_rows)

    # Final assignment of this rank's rows, then gathered in row order.
    c_norms = _c_norms(centroids)
    best, best_score = [], []
    for lo in range(0, rows_per_shard, block_rows):
        s, a = torch.max(_scores(x_local[lo : lo + block_rows], centroids, metric, c_norms), dim=1)
        best.append(a.to(torch.int32))
        best_score.append(s)
    best_t, score_t = torch.cat(best), torch.cat(best_score)
    live = torch.arange(rows_per_shard, device=dev) < n_local
    if metric == "l2":
        xf = x_local.float()
        per_row = torch.clamp(torch.sum(xf * xf, dim=-1) - score_t, min=0.0)
    else:
        per_row = -score_t
    inertia = mesh.all_reduce(torch.sum(torch.where(live, per_row, torch.zeros_like(per_row))))
    assignments = mesh.all_gather(best_t).reshape(-1)[:n_rows]
    return KMeansResult(centroids=centroids, assignments=assignments, inertia=inertia)
