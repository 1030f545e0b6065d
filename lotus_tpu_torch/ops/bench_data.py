"""Deterministic on-device dataset generation + IVF build for benchmarks.

Port of ``synth_ivf_device_build`` (``lotus_tpu/ops/bench_data.py:192-421``),
no-spill path.  The corpus is defined by a seed and generated on the device
chunk by chunk, twice (once to train, assign and fold into the exact f32
oracle, once to quantize and scatter), so the 10M x 768 f32 corpus (30 GB)
never exists whole.  Data model: clustered unit vectors (cluster centers
scaled by ``cluster_scale`` plus unit Gaussian noise, L2-normalised);
queries are perturbed copies of stored rows.  Ground truth is the exact f32
inner product against the unquantised vectors, with a running top-k.

Random numbers come from ``torch.Generator``s seeded per chunk, so they
differ from the reference's ``jax.random`` corpus; the port is held to its
own oracle.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

from lotus_tpu_torch.ops.common import NO_HIT
from lotus_tpu_torch.ops.ivf import default_device
from lotus_tpu_torch.ops.kmeans import kmeans_fit
from lotus_tpu_torch.ops.quant import quantize_refinement_int4


def _gen(seed: int, stream: int, device: torch.device) -> torch.Generator:
    """Generator for one named random stream of a seeded build."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + stream)


def gen_chunk(seed: int, c: int, centers: torch.Tensor, rows: int, cluster_scale: float) -> torch.Tensor:
    """Corpus chunk ``c``: pick a cluster per row, add unit noise, normalise."""
    g = _gen(seed, 16 + c, centers.device)
    pick = torch.randint(0, centers.shape[0], (rows,), generator=g, device=centers.device)
    x = centers[pick] * cluster_scale
    x += torch.randn(x.shape, generator=g, device=centers.device)
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def corpus_centers(seed: int, n_clusters: int, d: int, device: torch.device) -> torch.Tensor:
    return torch.randn((n_clusters, d), generator=_gen(seed, 0, device), device=device)


def _quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 (``bench_data.py:50-56``): scores factor as rowscale * int8dot."""
    m = torch.amax(torch.abs(x), dim=1)
    scale = torch.where(m > 0, m / 127.0, torch.ones_like(m))
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def _assign_top1(x: torch.Tensor, centroids: torch.Tensor, sub: int = 65536) -> torch.Tensor:
    """Nearest centroid by inner product, in sub-chunks so scores peak at (sub, nlist)."""
    return torch.cat([
        torch.argmax(x[lo : lo + sub] @ centroids.T, dim=1).to(torch.int32)
        for lo in range(0, x.shape[0], sub)
    ])


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def synth_ivf_device_build(
    *,
    n: int = 10_485_760,
    d: int = 768,
    nlist: int = 4096,
    n_clusters: int = 65536,
    cluster_scale: float = 2.5,
    chunk: int = 1_048_576,
    queries_b: int = 4096,
    gt_queries: int = 256,
    k: int = 10,
    block_align: int = 1024,
    seed: int = 0,
    kmeans_iters: int = 10,
    encoding: str = "residual_int8",
    spill_frac: float = 0.0,
    refine: bool = True,
    train_chunks: int = 2,
    device: torch.device | str | None = None,
    log: Callable[[str], Any] | None = None,
) -> dict[str, Any]:
    """Build a device-resident int8 IVF index over a seeded synthetic corpus.

    Returns a dict with the ``ivf_search_grouped_probe``-compatible
    ``state``, the query batch (f32, on the device), the f32-oracle ground
    truth (numpy), and the seconds of each phase.  Deterministic in
    ``seed`` on a given device.  ``spill_frac > 0`` (the SOAR-style spill
    build) is not ported yet and raises.
    """
    if spill_frac > 0:
        raise NotImplementedError("synth_ivf_device_build: the spill build is ROADMAP item M7 (rest)")
    if n % chunk != 0:
        raise ValueError("n must be a multiple of chunk")
    dev = torch.device(device) if device is not None else default_device()
    say = log or (lambda *_: None)
    n_chunks = n // chunk
    centers = corpus_centers(seed, n_clusters, d, dev)
    timings: dict[str, float] = {}

    # ---- pass 1: queries + coarse-quantizer training ------------------------
    t0 = time.perf_counter()
    x0 = gen_chunk(seed, 0, centers, chunk, cluster_scale)
    gq = _gen(seed, 1, dev)
    pick = torch.randint(0, chunk, (queries_b,), generator=gq, device=dev)
    xq = x0[pick] + 0.05 * torch.randn((queries_b, d), generator=gq, device=dev)
    xq = xq / torch.linalg.vector_norm(xq, dim=1, keepdim=True)
    xq_gt = xq[:gt_queries]
    train_x = torch.cat([x0, *(gen_chunk(seed, c, centers, chunk, cluster_scale)
                               for c in range(1, min(train_chunks, n_chunks)))])
    del x0
    res = kmeans_fit(train_x, nlist, iters=kmeans_iters, metric="l2", spherical=True,
                     generator=_gen(seed, 2, dev))
    centroids = res.centroids.float()
    del train_x, res
    _sync(dev)
    timings["train_s"] = time.perf_counter() - t0
    say(f"pass1: kmeans trained ({timings['train_s']:.1f}s)")

    # ---- pass 1b: exact f32 oracle + top-1 assignment, chunk by chunk -------
    t0 = time.perf_counter()
    best_s = torch.full((gt_queries, k), float("-inf"), device=dev)
    best_i = torch.full((gt_queries, k), -1, dtype=torch.int64, device=dev)
    a1_buf = torch.empty(n, dtype=torch.int32, device=dev)
    for c in range(n_chunks):
        x = gen_chunk(seed, c, centers, chunk, cluster_scale)
        s, i = torch.topk(xq_gt @ x.T, min(k, chunk), dim=1)
        cat_s, cat_i = torch.cat([best_s, s], 1), torch.cat([best_i, i + c * chunk], 1)
        best_s, pos = torch.topk(cat_s, k, dim=1)
        best_i = torch.gather(cat_i, 1, pos)
        a1_buf[c * chunk : (c + 1) * chunk] = _assign_top1(x, centroids)
    gt = best_i.cpu().numpy()
    timings["scan_s"] = time.perf_counter() - t0
    say(f"pass1: oracle + assignment over {n_chunks} chunks ({timings['scan_s']:.1f}s)")

    # ---- layout planning (on the device; only (nlist,) counts reach the host)
    t0 = time.perf_counter()
    list_size_np = torch.bincount(a1_buf, minlength=nlist).cpu().numpy().astype(np.int32)
    max_list = int(list_size_np.max())
    padded_size = np.maximum(((list_size_np + block_align - 1) // block_align) * block_align, block_align)
    list_start_np = np.zeros(nlist, np.int32)
    list_start_np[1:] = np.cumsum(padded_size)[:-1]
    total = int(padded_size.sum())
    window = max(block_align, int(((max_list + block_align - 1) // block_align) * block_align))
    list_start = torch.from_numpy(list_start_np).to(dev)
    order = torch.argsort(a1_buf, stable=True)
    sorted_assign = a1_buf[order].long()
    counts = torch.from_numpy(list_size_np).to(dev)
    start_unpadded = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    rank = torch.arange(n, dtype=torch.int32, device=dev) - start_unpadded[sorted_assign]
    dest_sorted = list_start[sorted_assign] + rank
    dest = torch.empty(n, dtype=torch.int32, device=dev)
    dest[order] = dest_sorted
    row_ids = torch.full((total + window,), NO_HIT, dtype=torch.int32, device=dev)
    row_ids[dest_sorted.long()] = order.to(torch.int32)
    del order, sorted_assign, rank, dest_sorted
    _sync(dev)
    timings["plan_s"] = time.perf_counter() - t0
    say(f"plan: entries={n:,} total={total:,} window={window}")

    # ---- pass 2: regenerate, quantise, scatter into the CSR buffer ---------
    t0 = time.perf_counter()
    total_padded = total + window
    buf = torch.zeros((total_padded, d), dtype=torch.int8, device=dev)
    scale_buf = torch.ones((total_padded,), dtype=torch.float32, device=dev)
    # Refinement is keyed by ORIGINAL row id, written contiguously.
    rbuf = torch.zeros((n, d // 2) if refine else (1, 1), dtype=torch.int8, device=dev)
    rs_buf = torch.zeros((n,) if refine else (1,), dtype=torch.float32, device=dev)
    residual = encoding == "residual_int8"
    quarter = max(1, chunk // 4)  # bounds the residual and r2 temporaries
    for c in range(n_chunks):
        x = gen_chunk(seed, c, centers, chunk, cluster_scale)
        for lo in range(0, chunk, quarter):
            r0 = c * chunk + lo
            part = x[lo : lo + quarter]
            if residual:
                part = part - centroids[a1_buf[r0 : r0 + quarter].long()]
            q8, sc = _quantize_rows(part)
            dst = dest[r0 : r0 + quarter].long()
            buf[dst] = q8
            scale_buf[dst] = sc
            if refine:
                r4, s4 = quantize_refinement_int4(part - q8.float() * sc[:, None])
                rbuf[r0 : r0 + quarter] = r4
                rs_buf[r0 : r0 + quarter] = s4
    _sync(dev)
    timings["pack_s"] = time.perf_counter() - t0
    say(f"pass2: {n_chunks} chunks packed ({timings['pack_s']:.1f}s)")

    meta = {
        "nlist": int(nlist), "max_list_size": int(max_list), "probe_window": int(window),
        "block_align": int(block_align), "metric": "ip", "encoding": encoding,
        "spill_frac": spill_frac, "refine": bool(refine), "n": n, "d": d, "seed": seed,
    }
    state = {
        "meta": meta,
        "centroids": centroids,
        "ivf_vectors": buf,
        "ivf_row_scales": scale_buf,
        "ivf_row_ids": row_ids,
        "ivf_list_start": list_start,
        "ivf_list_size": counts,
        # Every row's single storage position (used by exact rescoring).
        "ivf_inv_perm": dest,
    }
    if refine:
        state["ivf_refine"] = rbuf
        state["ivf_refine_scales"] = rs_buf
    build_s = sum(timings.values())
    return {
        "state": state,
        "queries": xq,
        "gt": gt,
        "timings": timings,
        "build_seconds": build_s,
        "build_vecs_per_s": n / build_s,
    }
