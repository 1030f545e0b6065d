"""Lloyd's k-means in torch: assign = blocked distance + argmax, update =
per-cluster sums (``index_add_``).

Port of ``lotus_tpu/ops/kmeans.py`` (``kmeans_fit`` :256-325,
``_kmeanspp_init`` :163-198, ``_kmeans_iterate`` :201-253, ``kmeans_assign``
:139 and ``kmeans_assign_top2`` :96).  Randomness comes from an explicit
``torch.Generator``; it draws other numbers than ``jax.random`` from the
same seed, so tests hand both packages the same initial centroids.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from lotus_tpu_torch.ops.common import check_metric, l2_normalize

DEFAULT_BLOCK_ROWS = 16384


@dataclass
class KMeansResult:
    centroids: torch.Tensor  # (k, d) f32
    assignments: torch.Tensor  # (N,) int32
    inertia: torch.Tensor  # () f32 — sum of squared distances (l2) or -sum sims


def _scores(block: torch.Tensor, centroids: torch.Tensor, metric: str, c_norms: torch.Tensor) -> torch.Tensor:
    """(block, d) x (k, d) -> (block, k) max-is-better scores in f32."""
    if block.dtype == torch.bfloat16:
        sims = block.float() @ centroids.to(torch.bfloat16).float().T
    else:
        sims = block.float() @ centroids.float().T
    return 2.0 * sims - c_norms[None, :] if metric == "l2" else sims


def _c_norms(centroids: torch.Tensor) -> torch.Tensor:
    c32 = centroids.float()
    return torch.sum(c32 * c32, dim=-1)


def kmeans_assign_top2(
    x: torch.Tensor, centroids: torch.Tensor, *, metric: str = "l2", block_rows: int | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-2 centroid assignment: (a1, a2, margin = s1 - s2 >= 0).

    Blocked so the score matrix peaks at (block_rows, k) regardless of N.
    """
    check_metric(metric)
    k = centroids.shape[0]
    if block_rows is None:
        block_rows = max(1024, min(DEFAULT_BLOCK_ROWS * 4, (1 << 26) // max(k, 1)))
    c_norms = _c_norms(centroids)
    a1s, a2s, mgs = [], [], []
    for lo in range(0, x.shape[0], block_rows):
        s = _scores(x[lo : lo + block_rows], centroids, metric, c_norms)
        s1, a1 = torch.max(s, dim=1)
        s.scatter_(1, a1[:, None], float("-inf"))
        s2, a2 = torch.max(s, dim=1)
        a1s.append(a1.to(torch.int32))
        a2s.append(a2.to(torch.int32))
        mgs.append(s1 - s2)
    return torch.cat(a1s), torch.cat(a2s), torch.cat(mgs)


def kmeans_assign(
    x: torch.Tensor, centroids: torch.Tensor, *, metric: str = "l2", block_rows: int = DEFAULT_BLOCK_ROWS
) -> tuple[torch.Tensor, torch.Tensor]:
    """Assign each row of x to its nearest centroid.

    Returns (assignments (N,) int32, distances (N,) f32) where distances
    follow the metric convention (squared l2, or similarity for ip/cosine).
    """
    check_metric(metric)
    c_norms = _c_norms(centroids)
    best, best_score = [], []
    for lo in range(0, x.shape[0], block_rows):
        s, a = torch.max(_scores(x[lo : lo + block_rows], centroids, metric, c_norms), dim=1)
        best.append(a.to(torch.int32))
        best_score.append(s)
    best_t, score_t = torch.cat(best), torch.cat(best_score)
    if metric == "l2":
        xf = x.float()
        return best_t, torch.clamp(torch.sum(xf * xf, dim=-1) - score_t, min=0.0)
    return best_t, score_t


def pp_distances(x32: torch.Tensor, x_sq: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared l2 distance of every row of ``x32`` to ``c`` as
    ||x||^2 - 2 x.c + ||c||^2, clamped at 0, with ``x_sq`` = ||x||^2 computed
    once: one matrix-vector product a round and no (n, d) difference tensor.
    It differs from sum((x - c)^2) by the cancellation of the expanded form,
    a few f32 ulps of ||x||^2 + ||c||^2."""
    return torch.clamp(x_sq - 2.0 * (x32 @ c) + torch.dot(c, c), min=0.0)


def _kmeanspp_init(x: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """k-means++ (D^2-weighted) seeding over x.

    Each of the k rounds scores all points against only the newest centroid
    (``pp_distances``).  The D^2 draw is Gumbel-max on log distances, as in
    the reference; the rounds stay on the device (no host sync per round).
    """
    n, d = x.shape
    x32 = x.float()
    dev = x32.device
    first = torch.randint(0, n, (), generator=generator, device=dev)
    centroids = torch.zeros((k, d), dtype=torch.float32, device=dev)
    x_sq = torch.sum(x32 * x32, dim=-1)
    min_d = torch.full((n,), float("inf"), device=dev)
    tiny = torch.finfo(torch.float32).tiny
    pick = first
    for j in range(k):
        if j:
            logits = torch.where(min_d > 0, torch.log(torch.clamp(min_d, min=tiny)), float("-inf"))
            u = torch.rand((n,), generator=generator, device=dev).clamp_(min=tiny)
            gumbel = -torch.log((-torch.log(u)).clamp_(min=tiny))
            pick = torch.argmax(logits + gumbel)
        c = x32[pick]
        centroids[j] = c
        min_d = torch.minimum(min_d, pp_distances(x32, x_sq, c))
        # The expanded form may leave the picked row a few ulps above 0; the
        # direct form's exact 0 keeps it from being drawn again.
        min_d[pick] = 0.0
    return centroids


def _kmeans_iterate(
    x: torch.Tensor,
    init_centroids: torch.Tensor,
    n_rows: int,
    k: int,
    metric: str,
    block_rows: int,
    iters: int,
    spherical: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd iterations: returns (centroids, per-iteration score sums).

    Empty clusters keep their previous centroid; ``spherical`` renormalises
    the centroids after every update.
    """
    d = x.shape[1]
    dev = x.device
    centroids = init_centroids
    score_hist = []
    for _ in range(iters):
        c32 = centroids.float()
        c_norms = torch.sum(c32 * c32, dim=-1)
        sums = torch.zeros((k, d), dtype=torch.float32, device=dev)
        counts = torch.zeros((k,), dtype=torch.float32, device=dev)
        score_acc = torch.zeros((), dtype=torch.float32, device=dev)
        for lo in range(0, min(n_rows, x.shape[0]), block_rows):
            block = x[lo : min(lo + block_rows, n_rows)]
            best_score, best = torch.max(_scores(block, centroids, metric, c_norms), dim=1)
            sums.index_add_(0, best, block.float())
            counts.index_add_(0, best, torch.ones_like(best_score))
            score_acc = score_acc + torch.sum(best_score)
        new_c = sums / torch.clamp(counts[:, None], min=1.0)
        new_c = torch.where(counts[:, None] > 0, new_c, c32)
        if spherical:
            new_c = l2_normalize(new_c)
        centroids = new_c.to(init_centroids.dtype)
        score_hist.append(score_acc)
    scores = torch.stack(score_hist) if score_hist else torch.zeros((0,), device=dev)
    return centroids, scores


def kmeans_fit(
    x: torch.Tensor,
    k: int,
    *,
    iters: int = 20,
    metric: str = "l2",
    generator: Optional[torch.Generator] = None,
    spherical: bool = False,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    max_points: Optional[int] = None,
    init: str = "kmeans++",
) -> KMeansResult:
    """Train k-means with Lloyd's algorithm.

    Args mirror ``lotus_tpu.ops.kmeans.kmeans_fit``; ``generator`` (a
    ``torch.Generator`` on ``x.device``, default seeded with 0) replaces the
    JAX key.  k-means++ seeds on a subsample of at most ``max(64k, 4096)``
    points.
    """
    check_metric(metric)
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    n = x.shape[0]
    if k > n:
        raise ValueError(f"k={k} > number of points {n}")
    dev = x.device

    train_x = x
    if max_points is not None and n > max_points:
        sel = torch.randperm(n, generator=generator, device=dev)[:max_points]
        train_x = x[torch.sort(sel).values]

    tn = train_x.shape[0]
    if init == "kmeans++":
        pp_cap = max(64 * k, 4096)
        if tn > pp_cap:
            sub = train_x[torch.randperm(tn, generator=generator, device=dev)[:pp_cap]]
        else:
            sub = train_x
        init_centroids = _kmeanspp_init(sub, k, generator)
    elif init == "random":
        init_centroids = train_x[torch.randperm(tn, generator=generator, device=dev)[:k]].float()
    else:
        raise ValueError(f"Unknown init {init!r}; expected 'kmeans++' or 'random'")
    if spherical:
        init_centroids = l2_normalize(init_centroids)

    centroids, _ = _kmeans_iterate(train_x, init_centroids, tn, k, metric, block_rows, iters, spherical)
    assignments, dists = kmeans_assign(x, centroids, metric=metric, block_rows=block_rows)
    inertia = torch.sum(dists) if metric == "l2" else -torch.sum(dists)
    return KMeansResult(centroids=centroids, assignments=assignments, inertia=inertia)
