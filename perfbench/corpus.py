"""The seeded config-4 corpus and its queries, frozen inside the benchmark.

``corpus_centers``, ``gen_chunk`` and ``sample_queries`` are copied from
``lotus_tpu_torch/ops/bench_data.py`` (``corpus_centers``, ``gen_chunk`` and
the query sampler of ``synth_ivf_device_build``'s pass 1), so that a later
change to the program's generator cannot change what the benchmark's
reference holds the store to: the store is built by the program from the same
seed, and the reference regenerates every row here.  The queries are the
benchmark's own stream, never the program's ``built["queries"]``.
"""

from __future__ import annotations

import torch

QUERY_STREAM = 7  # the benchmark's query stream; the program draws its own from stream 1


def _gen(seed: int, stream: int, device: torch.device) -> torch.Generator:
    """Generator for one named random stream of a seeded corpus (as ``bench_data._gen``)."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + stream)


def corpus_centers(seed: int, n_clusters: int, d: int, device: torch.device) -> torch.Tensor:
    return torch.randn((n_clusters, d), generator=_gen(seed, 0, device), device=device)


def gen_chunk(seed: int, c: int, centers: torch.Tensor, rows: int, cluster_scale: float) -> torch.Tensor:
    """Corpus chunk ``c``: pick a cluster per row, add unit noise, normalise."""
    g = _gen(seed, 16 + c, centers.device)
    pick = torch.randint(0, centers.shape[0], (rows,), generator=g, device=centers.device)
    x = centers[pick] * cluster_scale
    x += torch.randn(x.shape, generator=g, device=centers.device)
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def sample_queries(seed: int, cfg: dict, n: int, device: torch.device) -> torch.Tensor:
    """``n`` queries: stored rows of the first chunk, each perturbed by
    0.05 of unit noise and normalised (the program's sampler, on the
    benchmark's own stream)."""
    centers = corpus_centers(seed, cfg["n_clusters"], cfg["d"], device)
    x0 = gen_chunk(seed, 0, centers, cfg["chunk"], cfg["cluster_scale"])
    g = _gen(seed, QUERY_STREAM, device)
    pick = torch.randint(0, cfg["chunk"], (n,), generator=g, device=device)
    xq = x0[pick] + 0.05 * torch.randn((n, cfg["d"]), generator=g, device=device)
    return xq / torch.linalg.vector_norm(xq, dim=1, keepdim=True)
