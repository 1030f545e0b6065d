"""Deterministic on-device dataset generation + IVF build for benchmarks.

Port of ``synth_ivf_device_build`` (``lotus_tpu/ops/bench_data.py:192-421``)
with its SOAR-style spill build.  The corpus is defined by a seed and
generated on the device chunk by chunk, twice (once to train, assign and fold
into the exact f32 oracle, once to quantize and scatter), so the 10M x 768
f32 corpus (30 GB) never exists whole.  Data model: clustered unit vectors
(cluster centers scaled by ``cluster_scale`` plus unit Gaussian noise,
L2-normalised); queries are perturbed copies of stored rows.  Ground truth is the exact f32
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
from lotus_tpu_torch.ops.kmeans import kmeans_assign_top2, kmeans_fit
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


def plan_spill_layout(
    a1: torch.Tensor, a2: torch.Tensor, margins: torch.Tensor,
    spill_frac: float, nlist: int, block_align: int,
) -> dict[str, Any]:
    """The block-aligned layout of a build, spilled or not
    (``bench_data.py:280-327``).

    With ``spill_frac > 0`` the rows whose top-2 margin is at most its
    ``spill_frac`` quantile (on the host, as the reference takes it) get a
    second entry in their second list; entries go in the order of the
    reference's ``plan_block_aligned_layout`` (``ops/ivf.py:49``): all
    primaries, then the spill copies, stably sorted by list.  The sort runs on
    the device; only (nlist,) counts and the margins reach the host.

    Returns ``list_start`` / ``list_size`` (numpy int32), ``max_list``,
    ``window``, ``total``, and on the device: ``row_ids`` (total + window
    storage slots, NO_HIT on padding and the dead window tail),
    ``primary_dest`` (each row's primary storage position), ``spill_rows``
    (ascending) and ``spill_dest`` (their copies' positions).
    """
    dev = a1.device
    n = a1.shape[0]
    spill_rows = torch.empty(0, dtype=torch.int64, device=dev)
    if spill_frac > 0:
        mg = margins.cpu().numpy()
        tau = float(np.quantile(mg, spill_frac))
        spill_rows = torch.from_numpy(np.where(mg <= tau)[0].astype(np.int64)).to(dev)
    entry_assign = torch.cat([a1, a2[spill_rows]]).long()
    n_entries = entry_assign.shape[0]

    list_size_np = torch.bincount(entry_assign, minlength=nlist).cpu().numpy().astype(np.int32)
    max_list = int(list_size_np.max())
    padded_size = np.maximum(((list_size_np + block_align - 1) // block_align) * block_align, block_align)
    list_start_np = np.zeros(nlist, np.int32)
    list_start_np[1:] = np.cumsum(padded_size)[:-1]
    total = int(padded_size.sum())
    window = max(block_align, int(((max_list + block_align - 1) // block_align) * block_align))

    list_start = torch.from_numpy(list_start_np).to(dev)
    counts = torch.from_numpy(list_size_np).to(dev)
    order = torch.argsort(entry_assign, stable=True)
    sorted_assign = entry_assign[order]
    start_unpadded = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    rank = torch.arange(n_entries, dtype=torch.int32, device=dev) - start_unpadded[sorted_assign]
    dest_sorted = list_start[sorted_assign] + rank
    entry_dest = torch.empty(n_entries, dtype=torch.int32, device=dev)
    entry_dest[order] = dest_sorted
    # The logical row of each entry: entry i < n is row i, then the spilled rows.
    row_of_entry = torch.cat([torch.arange(n, device=dev), spill_rows]).to(torch.int32)
    row_ids = torch.full((total + window,), NO_HIT, dtype=torch.int32, device=dev)
    row_ids[dest_sorted.long()] = row_of_entry[order]
    return {
        "list_start": list_start_np, "list_size": list_size_np, "max_list": max_list,
        "window": window, "total": total, "row_ids": row_ids,
        "primary_dest": entry_dest[:n], "spill_rows": spill_rows, "spill_dest": entry_dest[n:],
    }


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
    first_chunk: int = 0,
    device: torch.device | str | None = None,
    log: Callable[[str], Any] | None = None,
) -> dict[str, Any]:
    """Build a device-resident int8 IVF index over a seeded synthetic corpus.

    Returns a dict with the ``ivf_search_grouped_probe``-compatible
    ``state``, the query batch (f32, on the device), the f32-oracle ground
    truth (numpy), each row's top-1 list (``assign``, on the device), the
    number of spilled copies, and the seconds of each phase.  Deterministic
    in ``seed`` on a given device.

    ``spill_frac > 0`` is the SOAR-style spill build: the ``spill_frac`` rows
    closest to a cell boundary (smallest top-2 margin) are stored in both
    lists, the copy as a residual against its second centroid with no
    refinement entry; ``ivf_inv_perm`` maps every row to its primary copy,
    the one its int4 refinement encodes, and ``meta["spill_frac"]`` makes
    the grouped probe dedup by row id.

    ``first_chunk > 0`` builds a row shard of the same seeded corpus: its
    rows are the corpus's chunks ``first_chunk ..`` (``n / chunk`` of them),
    its k-means trains on the first ``train_chunks`` of those, and its
    queries are the whole corpus's.  Row ids and the ground truth are then
    the shard's own (local ids over its rows).
    """
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
    if first_chunk:
        x0 = gen_chunk(seed, first_chunk, centers, chunk, cluster_scale)
    train_x = torch.cat([x0, *(gen_chunk(seed, first_chunk + c, centers, chunk, cluster_scale)
                               for c in range(1, min(train_chunks, n_chunks)))])
    del x0
    res = kmeans_fit(train_x, nlist, iters=kmeans_iters, metric="l2", spherical=True,
                     generator=_gen(seed, 2, dev))
    centroids = res.centroids.float()
    del train_x, res
    _sync(dev)
    timings["train_s"] = time.perf_counter() - t0
    say(f"pass1: kmeans trained ({timings['train_s']:.1f}s)")

    # ---- pass 1b: exact f32 oracle + top-2 assignment, chunk by chunk -------
    t0 = time.perf_counter()
    spill = spill_frac > 0
    best_s = torch.full((gt_queries, k), float("-inf"), device=dev)
    best_i = torch.full((gt_queries, k), -1, dtype=torch.int64, device=dev)
    a1_buf = torch.empty(n, dtype=torch.int32, device=dev)
    a2_buf = torch.empty(n if spill else 0, dtype=torch.int32, device=dev)
    mg_buf = torch.empty(n if spill else 0, dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        x = gen_chunk(seed, first_chunk + c, centers, chunk, cluster_scale)
        s, i = torch.topk(xq_gt @ x.T, min(k, chunk), dim=1)
        cat_s, cat_i = torch.cat([best_s, s], 1), torch.cat([best_i, i + c * chunk], 1)
        best_s, pos = torch.topk(cat_s, k, dim=1)
        best_i = torch.gather(cat_i, 1, pos)
        # The reference's _assign_top2 (bench_data.py:113-139): top-2 lists by
        # f32 inner product and the margin s1 - s2, in 65,536-row blocks so
        # the scores peak at (65536, nlist).
        a1, a2, mg = kmeans_assign_top2(x, centroids, metric="ip", block_rows=65536)
        a1_buf[c * chunk : (c + 1) * chunk] = a1
        if spill:
            a2_buf[c * chunk : (c + 1) * chunk] = a2
            mg_buf[c * chunk : (c + 1) * chunk] = mg
    gt = best_i.cpu().numpy()
    timings["scan_s"] = time.perf_counter() - t0
    say(f"pass1: oracle + assignment over {n_chunks} chunks ({timings['scan_s']:.1f}s)")

    # ---- layout planning (the sort on the device; counts and margins on the host)
    t0 = time.perf_counter()
    plan = plan_spill_layout(a1_buf, a2_buf, mg_buf, spill_frac, nlist, block_align)
    del mg_buf
    list_start_np, counts = plan["list_start"], torch.from_numpy(plan["list_size"]).to(dev)
    max_list, window, total = plan["max_list"], plan["window"], plan["total"]
    dest, spill_rows, spill_dest = plan["primary_dest"], plan["spill_rows"], plan["spill_dest"]
    spill_rows_np = spill_rows.cpu().numpy()
    spill_a2 = a2_buf[spill_rows].long()
    del a2_buf
    _sync(dev)
    timings["plan_s"] = time.perf_counter() - t0
    say(f"plan: entries={n + spill_rows_np.shape[0]:,} total={total:,} window={window}")

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
        x = gen_chunk(seed, first_chunk + c, centers, chunk, cluster_scale)
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
        # This chunk's spill copies (``bench_data.py:361-380``): residuals
        # against the second centroid, no refinement entry.  Eager torch
        # needs no static spill capacity, so nothing is padded into the dead
        # window tail as the reference's padding is.
        lo, hi = np.searchsorted(spill_rows_np, [c * chunk, (c + 1) * chunk])
        if hi > lo:
            part = x[spill_rows[lo:hi] - c * chunk]
            if residual:
                part = part - centroids[spill_a2[lo:hi]]
            q8, sc = _quantize_rows(part)
            dst = spill_dest[lo:hi].long()
            buf[dst] = q8
            scale_buf[dst] = sc
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
        "ivf_row_ids": plan["row_ids"],
        "ivf_list_start": torch.from_numpy(list_start_np).to(dev),
        "ivf_list_size": counts,
        # Every row's primary storage position, the copy its refinement
        # encodes (``bench_data.py:410-412``): exact rescoring reads it.
        # ``ensure_inv_perm`` would pick a spilled row's last copy instead.
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
        "assign": a1_buf,
        "spilled": int(spill_rows_np.shape[0]),
        "timings": timings,
        "build_seconds": build_s,
        "build_vecs_per_s": n / build_s,
    }
