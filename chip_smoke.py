#!/usr/bin/env python3
"""The kernel table of the lotus_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Each hand-written CUDA kernel alone at the shapes of the port's paths: held
to its plain PyTorch version on the same card tensors, and timed beside its
bound and beside that plain version.  The kernels' edges and what else only
the card shows are the ``cuda``-marked tests' (``python -m pytest
--noconftest -m cuda tests/test_torch_*_cuda.py tests/test_torch_profiling.py``);
end-to-end speed is the benchmark's (``perfbench/run.py``).

Phases (each prints its seconds and the card's name and power limit):
1. device: require CUDA; print the card's name and power limit;
2. build: compile the CUDA kernels from ``lotus_tpu_torch/csrc`` with nvcc,
   one process per source, all started together; report each K1, K2 and
   K3 kernel's registers, spills, wgmma advisories and HGMMA / IGMMA /
   UTMALDG counts, and fail if a tensor-core kernel has none of its type's
   MMA; K4's, K5's and K6's registers and spills;
3. K4 vs plain version: a ``DeepseekV2MoE`` layer at DeepSeek-V2-Lite's
   published widths (seeded bf16 weights) over the passage join's 64 x 512
   tokens, run once with the plain version standing in for K4; K4
   (``moe_combine``) against ``moe_combine_reference`` bit for bit on the
   arguments the layer's own ``routed`` gave the combine, both timed beside
   K4's byte bound; then the layer's main-path forward, its launches
   counted from 0, must launch K4 once and equal the recorded forward bit
   for bit;
3b. K6 vs plain version: K6 (``kda.scan_chunks``) against
   ``scan_chunks_reference`` on the same card tiles at the long-document
   cell's shape (8 x 8,192 tokens, 32 heads of 128, bf16-sourced q, k and
   v, seeded decays; the widest gap), both timed beside the recurrence's
   least time (``perfbench/bounds_kda.scan_least_s``); then one KDA layer
   of Kimi-Linear at the published widths (seeded bf16 weights) over 8,192
   tokens, its launches counted from 0, must launch K6's two kernels;
4. config 4 build: the seeded 10 * 2**20 x 768 corpus, IVF with nlist 4096,
   residual int8 + int4 refinement, block-aligned at 1024;
5. K1 vs plain: K1 (``probe_fold``) against ``probe_fold_reference`` for
   each variant, with the route each took: int8-dot packed (and under the
   top-1 fold) and int8 store with bf16 queries at the config-4 shape of
   one 2048-query slice, the first two timed beside their bound
   (``k1_bound``) and the plain version; bf16 packed, f32 unpacked, bf16 l2
   and f16 rows under f32 queries (packed and unpacked, the latter timed)
   on the first 512 lists at full width; the int8 dot at d 770 and 66 over
   the same lists (ragged last words; packed and unpacked, bit for bit, d
   770 packed timed); int8 over a window past 8192 rows (unpacked, top-2
   and top-1 folds); and the rescored top-10 sets of 256 bf16 queries
   through K1 and through the plain version, which must be equal;
6. K5 vs plain: K5 (``probe_layout``) against ``probe_layout_reference``
   on config 4's first 2048-query slice (its coarse ranking's 208 lists a
   query, int8 queries): the chunk table, each pair's slot, the block
   counts and every row of a live chunk bit for bit, both timed beside
   K5's bound (``k5_bound``);
7. K3 vs plain: K3 (``pool_select``) against ``pool_select_reference`` on
   the inputs ``ivf_search_grouped_probe`` (nprobe 208, rescore 24, int8
   queries, query_chunk 2048) gives it in its first slice (scores bit for
   bit, rows equal as sets across equal scores), both timed beside K3's
   bound (``k3_bound``);
8. the grouped probe's main path: ``ivf_search_grouped_probe`` at those
   settings over all 4096 queries, K1's, K3's and K5's launches counted
   from 0, must launch K1 and launch K3 and K5 once a slice;
9. K2 on the exhaustive scan's inputs: against its plain version on what
   ``ivf_residual_scan`` gives it (bf16 queries, the q.c bias plane and the
   row mask over the whole config-4 store at B = 256), both timed;
10. flat corpus: a seeded, normalised 2**20 x 768 corpus (4096 clusters)
   and 4096 queries;
11. K2 vs plain: K2 (``scan_fold``) against ``scan_fold_reference`` on the
   same card tensors: int8 store with int8 queries (bit for bit), int8 store
   with bf16 queries, bf16 store, f32 store, f16 store (timed beside its
   bound), an n_valid past a 1024 block, the bias and row-mask planes at
   blk 512 and 1024, and a d-1536 store (bf16, and int8 under bf16 and int8
   queries) whose query tile streams with the ring; times at the main shape
   (B = 4096 over all 2**20 rows) for bf16 and int8 beside their bounds,
   and for bf16 at d 1536.  The float variants hold every pool score within
   2e-5 * (1 + |s|), the best id of every lane whose best and second scores
   lie further apart than that, and the top-10 sets except at a near-tie.
   Last, K2 on the call a ``TorchVS`` Flat store under ``scan="pallas"``
   makes over 10,000 seeded f32 rows at d 1024 (256 queries, top 100),
   timed beside its bound (the small stores the models' text makes),
   after the store's own call, its launches counted from 0, launched K2.

Each K1 comparison prints its route (``wgmma+tma``, ``wgmma+tma+convert``,
or ``cuda-cores``) and query tile, each K2 comparison its store loader,
query tile and split plan.  The last three lines are the kernel table (K1,
K2, K3, K4, K5, K6, then the variants; each with its time, its plain version's,
its bound and what bounds it, and the largest difference from the plain
version; ``launches`` is the kernel's count on the main path that phase 3,
3b, 8 or 11 drives, and null for the variants), the card, and
``{"ok": true, "device": {...}}``.  Without a GPU, or without the
repository beside this file, it exits non-zero and prints no result.

``smoke_vocab`` and ``synth_texts`` are the originals of the copies in
``perfbench/texts.py``, which ``perfbench/tests`` holds to them.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
NPROBE, RESCORE, K, B, QUERY_CHUNK = 208, 24, 10, 4096, 2048
FLAT_N, FLAT_SEED = 2**20, 3
DEEP_N = 2**18  # rows of the d-1536 K2 comparison
# K2's float variants against the plain version: bf16 products are exact and
# the f32 sums run in another order (1.37e-6 at most at the main shape on an
# H100).  Rounding the output to bf16, or skipping the f32 store's rounding
# to bf16 before the dot, moves scores by 1e-5 or more.
K2_TOL = 2e-5
GPU = ""  # the card's "name, power limit", printed beside every time
# NVIDIA's H100 SXM data sheet (dense): the bounds' rates.
HBM_BYTES_PER_S, INT8_OPS_PER_S, BF16_OPS_PER_S, F32_OPS_PER_S = 3.35e12, 1979e12, 989e12, 67e12


def say(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        say(f"== {self.name}")
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0
        say(f"== {self.name}: {self.seconds:.3f} s [{GPU}]" + ("" if exc[0] is None else " (FAILED)"))
        return False


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` runs (CUDA events)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, args, *, bl, int8_dot, l2, packed, exact, tol=0.0, reps=0, top1=False):
    """Run K1 and its plain version on the same card tensors and hold them
    together; returns (max_abs_err, kernel ms, plain ms)."""
    import torch

    from lotus_tpu_torch.ops.ivf_probe import _LOCAL_MASK, probe_fold, probe_fold_reference

    kw = dict(bl=bl, int8_dot=int8_dot, l2=l2, packed=packed, top1=top1)
    got_s, got_i = probe_fold(*args, **kw)
    torch.cuda.synchronize()
    plan = probe_fold.last_plan
    ref_s, ref_i = probe_fold_reference(*args, **kw)
    torch.cuda.synchronize()
    if exact:
        same = torch.equal(got_s.view(torch.int32), ref_s.view(torch.int32))
        if not packed:
            same = same and torch.equal(got_i, ref_i)
        err = float((got_s.double() - ref_s.double()).abs().max())
        ok = same
    else:
        if packed:  # the low 13 bits carry ids: compare the scores they truncate
            got_s = (got_s.view(torch.int32) & ~_LOCAL_MASK).view(torch.float32)
            ref_s = (ref_s.view(torch.int32) & ~_LOCAL_MASK).view(torch.float32)
        diff = (got_s.double() - ref_s.double()).abs()
        err = float(diff.max())
        ok = bool((diff <= tol * (1.0 + ref_s.double().abs())).all())
    live = int((ref_s > -1e38).sum())
    ms = plain_ms = None
    if reps:
        ms = cuda_ms(lambda: probe_fold(*args, **kw), reps)
        plain_ms = cuda_ms(lambda: probe_fold_reference(*args, **kw), 1)
    say(f"  {name}: {'bitwise equal' if exact else f'tol {tol:g}'} -> {'OK' if ok else 'MISMATCH'}; "
        f"max_abs_err={err!r}; live candidates={live}"
        + ("" if ms is None else f"; K1 {ms:.3f} ms vs plain {plain_ms:.3f} ms [{GPU}]"))
    say(f"    route {plan['route']}; query tile {plan['query']}")
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version: {name}")
    return err, ms, plain_ms


def k2_row_scores(args, blk, qs, rows):
    """K2's score of query ``qs[j]`` against storage row ``rows[j]``, each
    pair by the plain formula on ``scan_fold``'s arguments ``args`` (rows
    rounded to bf16, times the row scale, plus the block's bias; -inf where
    the row mask drops the row)."""
    import torch

    xq, xb, _, scales, bias, row_mask = (*args, None, None, None)[:6]
    s = (xq[qs].double() * xb[rows].to(torch.bfloat16).double()).sum(1)
    if scales is not None:
        s = s * scales[rows].double()
    if bias is not None:
        s = s + bias[rows // blk, qs].double()
    if row_mask is not None:
        s = torch.where(row_mask[rows] == 0, float("-inf"), s)
    return s


def k2_compare(name, args, *, exact, blk=1024, reps=0, k=K):
    """Run K2 and its plain version on the same card tensors and hold them
    together: bit for bit, or each pool score within K2_TOL * (1 + |s|), the
    best id equal in every lane whose best and second scores lie further
    apart than that, and every id of K2's top ``k`` that the plain
    version's top ``k`` lacks a tie: a live row whose own score, rescored by
    ``k2_row_scores``, lies within that tolerance of the score K2 gives it
    (its lane slot's score already matches the plain version's).  Returns
    (max_abs_err, kernel ms, plain ms)."""
    import torch

    from lotus_tpu_torch.ops.flat_scan import NL, _pool_topk, scan_fold, scan_fold_reference

    got = scan_fold(*args, blk=blk)
    torch.cuda.synchronize()
    plan = scan_fold.last_plan
    ref = scan_fold_reference(*args, blk=blk)
    torch.cuda.synchronize()
    (gs, gi), (rs, ri) = ((torch.cat([p[0], p[2]], 1), torch.cat([p[1], p[3]], 1)) for p in (got, ref))
    diff = (gs.double() - rs.double()).abs()
    err = float(diff.max())
    ids = ""
    if exact:
        ok = torch.equal(gs.view(torch.int32), rs.view(torch.int32)) and torch.equal(gi, ri)
    else:
        tol = K2_TOL * (1.0 + rs.double().abs())
        close = bool((diff <= tol).all())
        clear = (rs[:, :NL] - rs[:, NL:]).double() > tol[:, :NL]
        same_best = torch.equal(gi[:, :NL][clear], ri[:, :NL][clear])
        (ts, ti), (_, ui) = (_pool_topk(p, None, k) for p in (got, ref))
        pairs = []  # (query, rank) of K2's top-k ids outside the plain version's
        for q, (a, b) in enumerate(zip(ti.tolist(), ui.tolist())):
            theirs = set(b)
            pairs += [(q, j) for j, i in enumerate(a) if i not in theirs]
        ties = True
        if pairs:
            qs, js = (torch.tensor(v, device=gs.device) for v in zip(*pairs))
            rows, claimed = ti[qs, js].long(), ts[qs, js].double()
            own = k2_row_scores(args, blk, qs, rows.clamp(0, args[1].shape[0] - 1))
            live_rows = bool(((rows >= 0) & (rows < min(int(args[2]), args[1].shape[0]))).all())
            ties = live_rows and bool(((claimed - own).abs() <= K2_TOL * (1.0 + claimed.abs())).all())
        ok = close and same_best and ties
        ids = (f"; best ids {'equal' if same_best else 'DIFFER'} in {int(clear.sum())} clear lanes; "
               f"{len(pairs)} top-{k} ids outside the plain version's, "
               f"{'each a tie' if ties else 'NOT all ties'}")
    live = int((rs > -1e38).sum())
    ms = plain_ms = None
    if reps:
        ms = cuda_ms(lambda: scan_fold(*args, blk=blk), reps)
        plain_ms = cuda_ms(lambda: scan_fold_reference(*args, blk=blk), 1)
    say(f"  {name}: {'bitwise equal' if exact else f'tol {K2_TOL:g}*(1+|s|), top-{k} sets up to ties'} -> "
        f"{'OK' if ok else 'MISMATCH'}; max_abs_err={err!r}; live candidates={live}{ids}"
        + ("" if ms is None else f"; K2 {ms:.3f} ms vs plain {plain_ms:.3f} ms [{GPU}]"))
    say(f"    loader {plan['loader']}; query tile {plan['query']}; "
        f"{plan['splits']} row splits of {plan['rows_per_split']:,} rows")
    if not ok:
        raise AssertionError(f"K2 disagrees with its plain version: {name}")
    return err, ms, plain_ms


def k3_bound(args, k_out: int) -> tuple[float, float]:
    """K3's bound on these inputs: the candidates of every pair whose list
    holds rows, the pair tables (row, list, bias) and the query scales read
    once, the (b, k_out) head written once, at 3.35 TB/s.  Returns (ms,
    bytes)."""
    cand, _, _, lists, _, sizes, bias, q_scales = args
    b, nprobe = lists.shape
    live = int((sizes[lists.long()] > 0).sum())
    nbytes = (live * cand.shape[-1] * 4 + b * nprobe * (8 + 4 + (4 if bias is not None else 0))
              + (b * 4 if q_scales is not None else 0) + b * k_out * 8)
    return 1e3 * nbytes / HBM_BYTES_PER_S, float(nbytes)


def k3_compare(state, queries, reps: int = 20):
    """K3 (``pool_select``) against ``pool_select_reference`` on the inputs
    the main path (``ivf_search_grouped_probe`` at config 4's settings) gives
    it for ``queries``, recorded through the plain version so that recording
    launches no K3: scores bit for bit; rows equal, as sets of (score, row),
    wherever the score is above MASK_SCORE / 2 and above the head's last
    score (where ties may take other candidates of the same score); both
    timed beside ``k3_bound``.  Returns (max_abs_err, ms, plain ms, bound
    ms, "bytes")."""
    import torch

    from lotus_tpu_torch.ops import ivf_probe
    from lotus_tpu_torch.ops.common import MASK_SCORE

    record, calls = recording(ivf_probe.pool_select_reference)
    kernel = ivf_probe.pool_select
    ivf_probe.pool_select = record
    try:
        ivf_probe.ivf_search_grouped_probe(state, queries, K, nprobe=NPROBE, metric="ip", rescore=RESCORE,
                                           int8_queries=True, query_chunk=QUERY_CHUNK)
    finally:
        ivf_probe.pool_select = kernel
    args, kw = calls[0]
    got_s, got_r = kernel(*args, **kw)
    ref_s, ref_r = ivf_probe.pool_select_reference(*args, **kw)
    torch.cuda.synchronize()
    bits, ref_bits = got_s.view(torch.int32), ref_s.view(torch.int32)
    bitwise = torch.equal(bits, ref_bits)
    above = (got_s > MASK_SCORE / 2) & (bits != bits[:, -1:])
    held = [torch.sort(torch.where(above, (v.long() << 32) | r.long(), -1), dim=1).values
            for v, r in ((bits, got_r), (ref_bits, ref_r))]
    rows_equal = torch.equal(*held)
    err = float((got_s.double() - ref_s.double()).abs().max())
    ms = cuda_ms(lambda: kernel(*args, **kw), reps)
    plain_ms = cuda_ms(lambda: ivf_probe.pool_select_reference(*args, **kw), 3)
    bound, nbytes = k3_bound(args, kw["k_out"])
    b, nprobe = args[3].shape
    say(f"  K3 at config 4's first slice (b {b}, nprobe {nprobe}, kc {args[0].shape[-1]}, k_out {kw['k_out']}, "
        f"{'packed' if kw['packed'] else 'unpacked'}, bias {args[6] is not None}, scale {args[7] is not None}): "
        f"scores {'bitwise equal' if bitwise else 'DIFFER'}, rows {'equal' if rows_equal else 'DIFFER'} "
        f"({int(above.sum()):,} head entries above the last score); max_abs_err={err!r}; K3 {ms:.3f} ms vs plain "
        f"{plain_ms:.3f} ms; bound {bound:.3f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s), K3 at "
        f"{100 * bound / ms:.1f}% of it [{GPU}]")
    assert bitwise and rows_equal, "K3 disagrees with its plain version on config 4's slice"
    return err, ms, plain_ms, bound, "bytes"


def k5_bound(probe_lists, xq_store, chunk_list, nlist: int) -> tuple[float, float]:
    """K5's bound on these inputs: the probe lists, the queries and the list
    sizes read once; each pair's slot, the chunk table, the block counts and
    the live chunks' query rows written once, at 3.35 TB/s.  Returns (ms,
    bytes)."""
    from lotus_tpu_torch.ops.ivf_probe import QU

    b, nprobe = probe_lists.shape
    row = xq_store.shape[1] * xq_store.element_size()
    live = int((chunk_list >= 0).sum())
    nbytes = b * nprobe * (4 + 8) + b * row + nlist * (4 + 4) + chunk_list.numel() * 4 + live * QU * row
    return 1e3 * nbytes / HBM_BYTES_PER_S, float(nbytes)


def k5_compare(lists, xq_store, sizes, bl: int, reps: int = 20):
    """K5 (``probe_layout``) against ``probe_layout_reference`` on the same
    card tensors (int8 queries): the chunk table, each pair's slot and the
    block counts equal, and every row of a live chunk equal (K5 leaves the
    rows of dead chunks unwritten, and K1 never reads them); both timed
    beside ``k5_bound``.  Returns (max_abs_err, ms, plain ms, bound ms,
    "bytes")."""
    import torch

    from lotus_tpu_torch.ops.ivf_probe import QU, probe_layout, probe_layout_reference

    args = (lists, xq_store, sizes, bl)
    units, chunk_list, padpos, blocks = probe_layout(*args)
    r_units, r_chunk_list, r_padpos, r_blocks = probe_layout_reference(*args)
    sync()
    live = torch.repeat_interleave(r_chunk_list[:-1] >= 0, QU)
    tables = (torch.equal(chunk_list, r_chunk_list) and torch.equal(padpos, r_padpos)
              and torch.equal(blocks, r_blocks))
    rows_equal = torch.equal(units[live], r_units[live])  # int8 rows: equal values are equal bits
    err = float((units[live].double() - r_units[live].double()).abs().max())
    ms = cuda_ms(lambda: probe_layout(*args), reps)
    plain_ms = cuda_ms(lambda: probe_layout_reference(*args), 3)
    bound, nbytes = k5_bound(lists, xq_store, r_chunk_list, sizes.shape[0])
    b, nprobe = lists.shape
    say(f"  K5 at config 4's first slice (b {b}, nprobe {nprobe}, nlist {sizes.shape[0]}, {xq_store.dtype} "
        f"queries at d {xq_store.shape[1]}, {int(live.sum()) // QU:,} live chunks of {r_chunk_list.numel() - 1:,}): "
        f"tables {'equal' if tables else 'DIFFER'}, live rows {'equal' if rows_equal else 'DIFFER'}; "
        f"max_abs_err={err!r}; K5 {ms:.4f} ms vs plain {plain_ms:.3f} ms; bound {bound:.4f} ms "
        f"({nbytes / 1e6:.1f} MB at 3.35 TB/s), K5 at {100 * bound / ms:.1f}% of it [{GPU}]")
    assert xq_store.dtype == torch.int8 and tables and rows_equal, "K5 disagrees with its plain version"
    return err, ms, plain_ms, bound, "bytes"


def k4_phase(dev, tokens: int = 64 * 512, reps: int = 20, widths: dict | None = None, seed: int = 21):
    """K4 (``moe_combine``) on a ``DeepseekV2MoE`` layer at DeepSeek-V2-Lite's
    published widths (``perfbench/configs/dsv2_lite.json``: hidden 2,048,
    64 routed experts of 1,408 and 2 shared, top-6; ``widths`` overrides
    them for a rehearsal) with seeded bf16 weights, over ``tokens`` seeded
    hidden states (the passage join's 64 x 512).  The layer's forward runs
    once with the plain version standing in for K4, which records the
    arguments its own ``routed`` gives the combine; K4 on them must equal
    ``moe_combine_reference`` bit for bit (the same f32 operations in the
    same order), and both are timed beside K4's byte bound (the held rows,
    the shared and output rows, the inverse and the weights moved once at
    3.35 TB/s).  Then the main path: ``moe_combine.launches`` set to 0, the
    layer's forward must launch K4 once and give the recorded forward's
    output bit for bit.  Returns ((max_abs_err, ms, plain ms, bound ms,
    "bytes"), launches)."""
    import torch

    from lotus_tpu_torch.models import deepseek_v2
    from lotus_tpu_torch.ops import moe_combine as combine

    with open(os.path.join(REPO, "perfbench", "configs", "dsv2_lite.json")) as f:
        raw = dict(json.load(f), **(widths or {}))
    cfg = deepseek_v2.DeepseekV2Config.from_dict(raw)
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.device(dev):
        layer = deepseek_v2.DeepseekV2MoE(cfg, 1).to(torch.bfloat16).eval()
    with torch.no_grad():
        for _, p in sorted(layer.named_parameters()):
            p.normal_(0.0, raw["initializer_range"], generator=g)
    x = torch.randn((tokens, cfg.hidden_size), generator=g, device=dev).to(torch.bfloat16)

    record, calls = recording(combine.moe_combine_reference)
    deepseek_v2.moe_combine = record
    try:
        with torch.inference_mode():
            y_plain = layer(x)
    finally:
        deepseek_v2.moe_combine = combine.moe_combine
    (out, inv, weights, offsets, shared), _ = calls[0]
    got = combine.moe_combine(out, inv, weights, offsets, shared)
    want = combine.moe_combine_reference(out, inv, weights, offsets, shared)
    sync(dev)
    bitwise = torch.equal(got, want)
    err = float((got.float() - want.float()).abs().max())
    ms = cuda_ms(lambda: combine.moe_combine(out, inv, weights, offsets, shared), reps)
    plain_ms = cuda_ms(lambda: combine.moe_combine_reference(out, inv, weights, offsets, shared), 3)
    held = int(offsets[-1])
    rows = held + 2 * tokens if shared is not None else held + tokens
    nbytes = rows * out.shape[1] * out.element_size() + inv.numel() * inv.element_size() + weights.numel() * 4
    bound = 1e3 * nbytes / HBM_BYTES_PER_S

    combine.moe_combine.launches = 0  # count only the main path's launches from here
    with torch.inference_mode():
        y = layer(x)
    sync(dev)
    launches = combine.moe_combine.launches
    same = torch.equal(y, y_plain)
    say(f"  K4 at the passage join's MoE layer (t {tokens:,}, k {weights.shape[1]}, hidden {out.shape[1]}, "
        f"{out.dtype}, {held:,} held pairs, shared {shared is not None}): {'bitwise equal' if bitwise else 'DIFFERS'}; "
        f"max_abs_err={err!r}; K4 {ms:.4f} ms vs plain {plain_ms:.3f} ms; bound {bound:.4f} ms "
        f"({nbytes / 1e9:.4f} GB at 3.35 TB/s), K4 at {100 * bound / ms:.1f}% of it [{GPU}]")
    say(f"  the layer's forward on the main path: K4 launches {launches}; output "
        f"{'bitwise equal to' if same else 'DIFFERS from'} the forward through the plain version")
    assert bitwise, "K4 disagrees with its plain version on the MoE layer's own inputs"
    assert launches == 1, f"the MoE layer's forward launched K4 {launches} times, not once"
    assert same, "the MoE layer's forward through K4 differs from the one through the plain version"
    return (err, ms, plain_ms, bound, "bytes"), launches


def k6_phase(dev, b: int = 8, t: int = 8192, heads: int = 32, reps: int = 10, seed: int = 25,
             layer_tokens: int = 8192) -> tuple:
    """K6 (``kda.scan_chunks``) at the long-document cell's shape: ``b`` x
    ``t`` tokens of ``heads`` heads of 128 (Kimi-Linear's, from
    ``perfbench/configs/kimi_linear.json``), bf16-sourced L2-normalised q
    and k and v, decays as the seeded layers draw them, in the chunk tiles
    the KDA layer makes.  K6 against ``scan_chunks_reference`` on the same
    tiles (the widest gap), both timed beside the recurrence's least time
    (``perfbench/bounds_kda.scan_least_s``: q, k, v and o in bf16, g and
    beta in f32, once at 3.35 TB/s).  Then the main path: one KDA layer at
    the published widths with seeded bf16 weights over ``layer_tokens``
    tokens, ``scan_chunks.launches`` set to 0, must launch K6's two
    kernels.  Returns ((max_abs_err, ms, plain ms, bound ms, bound by),
    launches)."""
    import torch
    import torch.nn.functional as F

    from lotus_tpu_torch.ops import kda
    from perfbench import bounds_kda
    from perfbench.adapters import _kimi

    with open(os.path.join(REPO, "perfbench", "configs", "kimi_linear.json")) as f:
        cfg = json.load(f)
    d = cfg["linear_attn_config"]["head_dim"]
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k = (F.normalize(torch.randn(b, t, heads, d, device=dev, generator=g), dim=-1).bfloat16()
            for _ in range(2))
    v = torch.randn(b, t, heads, d, device=dev, generator=g).bfloat16()
    a = 1 + 15 * torch.rand(heads, device=dev, generator=g)
    decay = -a.view(heads, 1) * F.softplus(0.2 * torch.randn(b, t, heads, d, device=dev, generator=g) - 4)
    beta = torch.rand(b, t, heads, device=dev, generator=g)
    tiles = [kda.from_rows(x) for x in (q, k, v, decay)] + [kda.from_rows(beta.unsqueeze(-1))]
    del q, k, v, decay, beta
    with torch.inference_mode():
        got = kda.scan_chunks(*tiles)
        want = kda.scan_chunks_reference(*tiles)
        sync(dev)
        err = float((got - want).abs().max())
        del got, want
        ms = cuda_ms(lambda: kda.scan_chunks(*tiles), reps)
        plain_ms = cuda_ms(lambda: kda.scan_chunks_reference(*tiles), 2)
    least = bounds_kda.scan_least_s(cfg, float(b * t * heads))
    bound = 1e3 * least["s"]
    n, bh = tiles[0].shape[:2]
    del tiles
    torch.cuda.empty_cache()

    one = {**cfg, "num_hidden_layers": 1,
           "linear_attn_config": {**cfg["linear_attn_config"], "kda_layers": [1], "full_attn_layers": []}}
    model = _kimi.build_model(one, seed, dev)
    ids = torch.randint(0, cfg["vocab_size"], (1, layer_tokens), generator=g, device=dev)
    kda.scan_chunks.launches = 0  # count only the main path's launches from here
    with torch.inference_mode():
        out = model(ids, torch.ones_like(ids))
    sync(dev)
    launches = kda.scan_chunks.launches
    finite = bool(torch.isfinite(out).all())
    del model, out
    say(f"  K6 at the long-document cell's shape ({b} x {t:,} tokens, {heads} heads of {d}: {n} chunks x {bh} "
        f"tiles): max_abs_err={err!r} against the plain version; K6 {ms:.3f} ms vs plain {plain_ms:.3f} ms; "
        f"bound {bound:.4f} ms ({least['by']}: {least['bytes'] / 1e9:.3f} GB at 3.35 TB/s), K6 at "
        f"{100 * bound / ms:.2f}% of it [{GPU}]")
    say(f"  one KDA layer's forward over {layer_tokens:,} tokens on the main path: K6 launches {launches}, "
        f"output {'finite' if finite else 'NOT FINITE'}")
    assert err <= 2e-6, "K6 disagrees with its plain version"
    assert launches == kda.K6_LAUNCHES, f"a KDA layer's forward launched K6 {launches} times"
    assert finite, "a KDA layer's forward through K6 is not finite"
    return (err, ms, plain_ms, bound, least["by"]), launches


def kernel_report() -> None:
    """K1's to K6's kernels as built: registers and spill bytes from ptxas,
    ptxas's wgmma advisories counted by code (an injected warpgroup.wait or
    arrive: C7517, C7519; serialized wgmma: C7510, C7514), and the
    tensor-core (HGMMA bf16, IGMMA int8) and TMA-load (UTMALDG) instructions
    that ``cuobjdump -sass`` shows in each.  Fails unless every bf16
    tensor-core instantiation (K2's scan_kernel, K1's probe_wgmma) has HGMMA
    and every int8 one IGMMA.  K1's probe_cores (f32, and rows TMA cannot
    take), K3's pool_select (a selection, no dot), K4's moe_combine (a
    weighted sum of gathered rows), K5's probe_layout kernels (bit
    tables, scans and row copies) and K6's kda_chunk_stage and
    kda_state_stage (f32 products, which no tensor-core type keeps) run on
    the CUDA cores by design."""
    from lotus_tpu_torch.ops import _kernels

    ptxas = {}
    for part in _kernels.build_log.split("Compiling entry function '")[1:]:
        name = part.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", part)
        ptxas[name] = (regs and int(regs.group(1)), spill and (int(spill.group(1)), int(spill.group(2))))
    notes: dict[str, dict[str, int]] = {}
    for m in re.finditer(r"\((C75(?:10|14|17|19))\).*?function '([^']+)'", _kernels.build_log):
        per = notes.setdefault(m.group(2), {})
        per[m.group(1)] = per.get(m.group(1), 0) + 1
    sass = subprocess.run([_kernels.cuda_tool("cuobjdump"), "-sass", str(_kernels.build())],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = dict.fromkeys(("HGMMA", "IGMMA", "UTMALDG"), 0)
        elif fn is not None:
            for op in counts[fn]:
                counts[fn][op] += op in line
    for kind in ("scan_kernel", "probe_wgmma", "probe_cores", "pool_select", "moe_combine", "probe_layout", "kda_"):
        found = sorted(f for f in counts if kind in f)
        assert found, f"no {kind} in the built library"
        for f in found:
            int8_dot = f"{kind}Ia" in f  # the operand type is int8
            regs, spill = ptxas.get(f, (None, None))
            dot = {"pool_select": "selection", "moe_combine": "weighted sum", "probe_layout": "layout",
                   "kda_": "f32 recurrence"}.get(kind, f"{'int8' if int8_dot else 'float'} dot")
            say(f"  {f}: {dot}; ptxas {regs} registers, spill "
                f"stores/loads {spill} bytes, wgmma advisories {notes.get(f, {})}; SASS {counts[f]}")
            if kind in ("scan_kernel", "probe_wgmma"):
                op = "IGMMA" if int8_dot else "HGMMA"
                assert counts[f][op] > 0, f"{f} has no {op}: not on the tensor cores"


def k1_bound(units, vecs, chunk_list, sizes, *, int8_dot, packed, top1=False, rate=None):
    """K1's bound on this card for one launch: the larger of its bytes (each
    probed list's live rows, whole 64-row slices, and their scales read once;
    the live chunks' query tiles; the whole output written) over 3.35 TB/s
    and its operations (2 * 128 * d per live row of every live chunk) over
    the dense tensor-core rate (int8 1,979 TOP/s, bf16 989 TFLOP/s) or
    ``rate`` (f32 variants: 67 TFLOP/s outside the tensor cores), from
    NVIDIA's H100 SXM data sheet.  Returns (ms, "bytes" or "operations",
    live chunks, MACs, bytes the kernel streams: every live chunk's rows)."""
    import torch

    from lotus_tpu_torch.ops.ivf_probe import QU, ncand

    d = vecs.shape[1]
    live = chunk_list[chunk_list >= 0].long()

    def rows64(lists):  # live rows of these lists, whole 64-row slices
        return float((((sizes[lists].double() + 63) // 64) * 64).sum())

    row_bytes = d * vecs.element_size() + (4 if vecs.dtype == torch.int8 else 0)
    out_bytes = chunk_list.numel() * QU * ncand(top1) * (4 if packed else 8)
    q_bytes = live.numel() * QU * d * units.element_size()
    need = rows64(torch.unique(live)) * row_bytes + q_bytes + out_bytes
    macs = QU * d * rows64(live)
    t_bytes = need / HBM_BYTES_PER_S
    t_ops = 2 * macs / (rate or (INT8_OPS_PER_S if int8_dot else BF16_OPS_PER_S))
    streamed = rows64(live) * row_bytes + q_bytes + out_bytes
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", int(live.numel()),
            macs, streamed)


def sync(dev=None) -> None:
    """Wait for ``dev`` (default: the current card); a CPU device has nothing to wait for."""
    import torch

    if dev is None or torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)



CONFIG4 = dict(n=10 * 2**20, d=768, nlist=4096, n_clusters=65536, cluster_scale=2.5, chunk=2**18,
               queries_b=B, gt_queries=256, k=K, block_align=1024, seed=0)


VOCAB_SIZE = 30_522  # bert-base-uncased's vocabulary size
TOPIC_WORDS, ON_TOPIC = 4, 0.9


def recording(plain):
    """A stand-in for a kernel's wrapper that records the arguments of each
    call and answers through ``plain``, the kernel's plain version, so it
    launches nothing.  Returns (the stand-in, its list of (args, kwargs))."""
    calls = []

    def record(*args, **kw):
        calls.append((args, kw))
        return plain(*args, **kw)

    return record, calls


def smoke_vocab(seed: int = 0, size: int = VOCAB_SIZE) -> list[str]:
    """A seeded ``size``-entry WordPiece vocabulary in bert-base-uncased's
    layout: ``[PAD]``, ``[unused*]``, ``[UNK]`` ``[CLS]`` ``[SEP]``
    ``[MASK]`` at 100-103, single characters and their ``##`` forms, then
    seeded whole words (3-10 letters) and ``##`` pieces (2-4 letters); a
    larger ``size`` extends the smaller one's list."""
    import string

    import numpy as np

    vocab = ["[PAD]", *(f"[unused{i}]" for i in range(99)), "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    chars = string.punctuation + string.digits + string.ascii_lowercase
    vocab += list(chars) + ["##" + c for c in string.digits + string.ascii_lowercase]
    rng = np.random.default_rng(seed)
    letters = np.array(list(string.ascii_lowercase))
    seen = set(vocab)
    while len(vocab) < size:
        piece = rng.random() < 0.15
        tok = ("##" if piece else "") + "".join(rng.choice(letters, rng.integers(2, 5) if piece else rng.integers(3, 11)))
        if tok not in seen:
            seen.add(tok)
            vocab.append(tok)
    return vocab



def synth_texts(vocab: list[str], n: int, lo: int, hi: int, seed: int, per_topic: int = 10) -> list[str]:
    """``n`` seeded texts of ``lo``-``hi`` words on ``n // per_topic`` topics,
    ``per_topic`` texts each (a seeded shuffle; the same topics for the same
    ``n``, ``per_topic`` and lengths).  A topic has one length, its texts
    within two words of it, and a text draws each word with probability
    ON_TOPIC from its topic's TOPIC_WORDS, else from the whole vocabulary;
    one word in 20 is two words run together, which WordPiece splits into
    ``##`` pieces."""
    import numpy as np

    words = np.array([w for w in vocab if w.isalpha() and len(w) > 2 and not w.startswith("[")], dtype=object)
    topics = max(1, n // per_topic)
    topic_rng = np.random.default_rng(12345)
    topic_words = topic_rng.integers(0, len(words), (topics, TOPIC_WORDS))
    topic_len = topic_rng.integers(lo + 2, hi - 1, topics)
    rng = np.random.default_rng(seed)
    doc_topic = rng.permutation(n) % topics
    lengths = topic_len[doc_topic] + rng.integers(-2, 3, n)
    total = int(lengths.sum())
    topic = np.repeat(doc_topic, lengths)
    idx = np.where(rng.random(total) < ON_TOPIC, topic_words[topic, rng.integers(0, TOPIC_WORDS, total)],
                   rng.integers(0, len(words), total))
    flat = words[idx]
    joined = rng.random(total) < 0.05
    flat[joined] = flat[joined] + words[rng.integers(0, len(words), int(joined.sum()))]
    cuts = np.cumsum(lengths)[:-1]
    return [" ".join(ws).capitalize() + "." for ws in np.split(flat, cuts)]



def k2_store_compare(label: str, store, qv, top: int) -> list:
    """K2 against its plain version on the inputs a ``scan="pallas"`` Flat
    store's call gives it: the same call once more, with the wrapper
    recording them (``k2_compare`` at k ``top``, timed).  Returns
    ``k2_compare``'s figures and the arguments of each call."""
    import torch

    from lotus_tpu_torch.ops import flat_scan

    scan_fold = flat_scan.scan_fold
    record, calls = recording(flat_scan.scan_fold_reference)
    flat_scan.scan_fold = record
    try:
        store(qv, top)
    finally:
        flat_scan.scan_fold = scan_fold
    assert calls, "the scan='pallas' store did not call K2's wrapper"
    return [(k2_compare(f"{label}: the Flat store's {args[1].dtype} rows ({args[1].shape[0]:,} x {args[1].shape[1]}), "
                        f"{args[0].shape[0]} {args[0].dtype} queries, top {top}", args,
                        exact=args[0].dtype == torch.int8, k=top, reps=5, **kw), args) for args, kw in calls]



def config4_kernels(dev) -> dict:
    """Phases 4-9 over config 4's store, which lives only in this function's
    frame.  Returns each kernel's figures by row: (max_abs_err, ms, plain
    ms, bound ms, bound_by); and K1's, K3's and K5's launches on the main
    path."""
    import torch

    from lotus_tpu_torch.ops.bench_data import synth_ivf_device_build
    from lotus_tpu_torch.ops.flat import flat_search
    from lotus_tpu_torch.ops.flat_scan import residual_scan_inputs
    from lotus_tpu_torch.ops.ivf_probe import (LOCAL_BITS, ivf_search_grouped_probe, pool_select, probe_fold,
                                               probe_fold_reference, probe_layout)
    from lotus_tpu_torch.ops.quant import quantize_rows

    with Phase("config 4 build"):
        torch.cuda.reset_peak_memory_stats()
        built = synth_ivf_device_build(**CONFIG4, device=dev, log=say)
        state, xq = built["state"], built["queries"]
        meta = state["meta"]
        say(f"  build {built['build_seconds']:.2f} s; window {meta['probe_window']}; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{GPU}]")

    with Phase("K1 vs plain version"):
        bl = int(meta["block_align"])
        vecs, scales = state["ivf_vectors"], state["ivf_row_scales"]
        starts, sizes = state["ivf_list_start"], state["ivf_list_size"]
        q = xq[:QUERY_CHUNK]
        _, lists = flat_search(state["centroids"], q, NPROBE, metric="ip")
        packed_main = int(meta["probe_window"]) <= (1 << LOCAL_BITS)
        units, chunk_list, _, _ = probe_layout(lists.to(torch.int32), quantize_rows(q)[0], sizes, bl)
        main_args = (units, vecs, scales, None, chunk_list, starts, sizes)
        main = compare(
            f"int8-dot {'packed' if packed_main else 'unpacked'} (config 4, {QUERY_CHUNK} queries)",
            main_args, bl=bl, int8_dot=True, l2=False, packed=packed_main, exact=True, reps=10,
        )
        main_bound, main_by, n_live, macs, streamed = k1_bound(
            units, vecs, chunk_list, sizes, int8_dot=True, packed=packed_main)
        main_ms = main[1]
        say(f"  K1 work: {macs:.4e} int8 MACs in {n_live} live chunks -> "
            f"{2 * macs / (main_ms * 1e-3) / 1e12:.1f} TOP/s; bound {main_bound:.3f} ms ({main_by}; each probed "
            f"list read once), K1 at {100 * main_bound / main_ms:.1f}% of it; the live chunks stream "
            f"{streamed / 1e9:.3f} GB ({1e3 * streamed / HBM_BYTES_PER_S:.3f} ms at 3.35 TB/s) [{GPU}]")
        units_bf, _, _, _ = probe_layout(lists.to(torch.int32), q.to(torch.bfloat16), sizes, bl)
        bf = compare(
            "int8 store, bf16 queries (dequant), config 4",
            (units_bf, vecs, scales, None, chunk_list, starts, sizes), bl=bl, int8_dot=False,
            l2=False, packed=packed_main, exact=False, tol=2e-3, reps=5)
        bf_bound, bf_by, _, _, _ = k1_bound(units_bf, vecs, chunk_list, sizes, int8_dot=False, packed=packed_main)
        say(f"  bf16-query K1 {bf[1]:.3f} ms; bound {bf_bound:.3f} ms ({bf_by}), K1 at "
            f"{100 * bf_bound / bf[1]:.1f}% of it [{GPU}]")
        rows_out = {"K1": (*main, main_bound, main_by), "K1 bf16 queries": (*bf, bf_bound, bf_by)}
        # The top-1 fold at the config-4 shape: packed, bit for bit.
        compare("top-1 fold, int8-dot packed (config 4)", main_args, bl=bl, int8_dot=True, l2=False,
                packed=packed_main, exact=True, top1=True)
        # The rescored top-k through the plain version equals K1's.
        kw = dict(nprobe=NPROBE, metric="ip", int8_queries=False, rescore=RESCORE)
        _, i_k1 = ivf_search_grouped_probe(state, xq[:256], K, **kw)
        _, i_pl = ivf_search_grouped_probe(state, xq[:256], K, fold=probe_fold_reference, **kw)
        same_sets = all(set(a) == set(b) for a, b in zip(i_k1.tolist(), i_pl.tolist()))
        say(f"  rescored top-{K} sets, K1 vs plain (bf16 queries, 256 queries): "
            f"{'equal' if same_sets else 'DIFFER'}")
        assert same_sets, "rescored top-k sets differ between K1 and its plain version"

        # Float stores at full width over the first 512 lists.
        nl = 512
        rows = int(starts[nl])
        xf = vecs[:rows].float() * scales[:rows, None]
        g = torch.Generator(device=dev).manual_seed(5)
        sub_lists = torch.argsort(torch.rand((512, nl), generator=g, device=dev), dim=1)[:, :26].to(torch.int32)
        sub = (starts[:nl].contiguous(), sizes[:nl].contiguous())
        for name, xs, qdt, l2, packed in (
            ("bf16 store, packed", xf.to(torch.bfloat16), torch.bfloat16, False, True),
            ("f32 store, unpacked", xf, torch.float32, False, False),
            ("bf16 store, l2, unpacked", xf.to(torch.bfloat16), torch.bfloat16, True, False),
            ("f16 store, f32 queries, unpacked", xf.to(torch.float16), torch.float32, False, False),
            ("f16 store, f32 queries, packed", xf.to(torch.float16), torch.float32, False, True),
        ):
            units_s, cl_s, _, _ = probe_layout(sub_lists, xq[:512].to(qdt), sub[1], bl)
            norms = (xs.float() ** 2).sum(1) if l2 else None
            f16 = xs.dtype == torch.float16 and not packed
            out = compare(name, (units_s, xs, None, norms, cl_s, *sub), bl=bl, int8_dot=False, l2=l2,
                          packed=packed, exact=False, tol=1e-4 if not packed else 2e-3, reps=3 if f16 else 0)
            if f16:
                rows_out["K1 f16"] = (*out, *k1_bound(units_s, xs, cl_s, sub[1], int8_dot=False, packed=False,
                                                          rate=F32_OPS_PER_S)[:2])
        del xf
        # The int8 dot at depths that are not whole 32-bit words (d 770 and
        # 66), packed and unpacked, bit for bit: config 4's rows of these
        # lists widened or cut.
        x8, q8 = vecs[:rows], quantize_rows(xq[:512])[0]
        for dd in (770, 66):
            xs = (torch.cat([x8, x8[:, : dd - 768]], 1) if dd > 768 else x8[:, :dd]).contiguous()
            qs = (torch.cat([q8, q8[:, : dd - 768]], 1) if dd > 768 else q8[:, :dd]).contiguous()
            units_r, cl_r, _, _ = probe_layout(sub_lists, qs, sub[1], bl)
            for packed in (True, False):
                timed = dd == 770 and packed
                out = compare(f"int8-dot at d {dd}, {'packed' if packed else 'unpacked'}",
                              (units_r, xs, scales[:rows], None, cl_r, *sub), bl=bl, int8_dot=True, l2=False,
                              packed=packed, exact=True, reps=3 if timed else 0)
                if timed:
                    rows_out["K1 int8 d770"] = (*out, *k1_bound(units_r, xs, cl_r, sub[1], int8_dot=True,
                                                                    packed=True)[:2])
        del x8, xs

        # A window past 8192 rows: lists of 12 blocks (unpacked, ids compared).
        span = 12 * bl
        nwin = 10
        w_starts = torch.arange(0, nwin * span, span, dtype=torch.int32, device=dev)
        w_sizes = (span - torch.tensor([0, 5, 100, 1023, 1024, 3000, 7, 0, 64, 65],
                                       dtype=torch.int32, device=dev)).contiguous()
        w_lists = torch.argsort(torch.rand((256, nwin), generator=g, device=dev), dim=1)[:, :4].to(torch.int32)
        units_w, cl_w, _, _ = probe_layout(w_lists, quantize_rows(xq[:256])[0], w_sizes, bl)
        for top1 in (False, True):
            compare(f"int8-dot, window 12288 rows (unpacked{', top-1 fold' if top1 else ''})",
                    (units_w, vecs, scales, None, cl_w, w_starts, w_sizes), bl=bl, int8_dot=True, l2=False,
                    packed=False, exact=True, top1=top1)

    with Phase("K5 vs plain version"):
        rows_out["K5"] = k5_compare(lists.to(torch.int32), quantize_rows(q)[0], sizes, bl)
    with Phase("K3 vs plain version"):
        rows_out["K3"] = k3_compare(state, xq[:QUERY_CHUNK])
    with Phase("the grouped probe's main path (K1, K3 and K5 launches)"):
        probe_fold.launches = pool_select.launches = probe_layout.launches = 0  # this path's launches
        ivf_search_grouped_probe(state, xq, K, nprobe=NPROBE, metric="ip", rescore=RESCORE, int8_queries=True,
                                 query_chunk=QUERY_CHUNK)
        sync(dev)
        launched = {"K1": probe_fold.launches, "K3": pool_select.launches, "K5": probe_layout.launches}
        slices = -(-xq.shape[0] // QUERY_CHUNK)
        say(f"  ivf_search_grouped_probe over {xq.shape[0]} int8 queries ({slices} slices): K1 launches "
            f"{launched['K1']}, K3 launches {launched['K3']}, K5 launches {launched['K5']}")
        assert launched["K1"] > 0, "the grouped probe did not launch K1"
        assert launched["K3"] == slices, "the grouped probe did not launch K3 once a slice"
        assert launched["K5"] == slices, "the grouped probe did not launch K5 once a slice"
    with Phase("K2 on the exhaustive scan's inputs (ivf_residual_scan)"):
        args, blk, _ = residual_scan_inputs(state, xq[:256])
        k2_compare(f"int8 store, bf16 queries, q.c bias + row mask, blk {blk} (ivf_residual_scan's inputs, "
                   f"B 256 x {args[2]:,} rows)", args, blk=blk, exact=False, reps=3)
    return rows_out, launched


def flat_corpus(dev):
    """The flat-scan setting's seeded corpus (2**20 x 768 f32, normalised),
    its B queries, and the generator that drew them."""
    import torch

    from lotus_tpu_torch.ops.bench_data import corpus_centers, gen_chunk

    centers = corpus_centers(FLAT_SEED, 4096, 768, dev)
    corpus = gen_chunk(FLAT_SEED, 0, centers, FLAT_N, 2.5)
    g = torch.Generator(device=dev).manual_seed(FLAT_SEED)
    fq = corpus[torch.randint(0, FLAT_N, (B,), generator=g, device=dev)]
    fq = fq + 0.05 * torch.randn((B, 768), generator=g, device=dev)
    return corpus, fq / torch.linalg.vector_norm(fq, dim=1, keepdim=True), g


def k2_store_phase(dev, n: int = 10_000, d: int = 1024, nq: int = 256, top: int = 100) -> tuple:
    """K2 on the call a ``TorchVS`` Flat store under ``scan="pallas"`` makes
    over ``n`` seeded f32 rows of depth ``d`` (RoBERTa-large's store from
    config 1's 10,000 passages): ``nq`` seeded queries at k ``top``, held to
    the plain version and timed beside K2's bound; before that, the store's
    own call with ``scan_fold.launches`` set to 0 must launch K2.  Returns
    ((max_abs_err, ms, plain ms, bound ms, bound_by), launches)."""
    import torch

    from lotus_tpu_torch import TorchVS
    from lotus_tpu_torch.ops.bench_data import corpus_centers, gen_chunk
    from lotus_tpu_torch.ops.flat_scan import scan_fold

    rows = gen_chunk(27, 0, corpus_centers(27, 64, d, dev), n, 2.5)
    g = torch.Generator(device=dev).manual_seed(27)
    qv = rows[:nq] + 0.05 * torch.randn((nq, d), generator=g, device=dev)
    index_dir = os.path.join(REPO, "build", "lotus_tpu_torch", "smoke_flat_index")
    shutil.rmtree(index_dir, ignore_errors=True)
    vs = TorchVS(index_type="flat", scan="pallas", device=dev)
    vs.index([], rows.cpu().numpy(), index_dir)
    qv = qv.cpu().numpy()
    vs(qv[:8], K)  # loads the store
    scan_fold.launches = 0  # this path's launches
    vs(qv, top)
    launches = scan_fold.launches
    say(f"  the scan='pallas' store's call ({nq} queries, top {top}): K2 launches {launches}")
    assert launches > 0, "the scan='pallas' store did not launch K2"
    (err, ms, plain_ms), args = k2_store_compare(f"{n:,} x {d} f32 rows", vs, qv, top)[0]
    xq, xb = args[0], args[1]
    b_, n_, d_ = xq.shape[0], int(args[2]), xb.shape[1]
    need = n_ * d_ * xb.element_size() + b_ * d_ * xq.element_size() + b_ * 256 * 8
    t_bytes, t_ops = need / HBM_BYTES_PER_S, 2.0 * b_ * n_ * d_ / BF16_OPS_PER_S
    bound = (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    say(f"  K2 at d {d_} ({b_} x {n_:,} x {d_}, {xb.dtype} rows): {ms:.4f} ms vs plain {plain_ms:.4f} ms; bound "
        f"{bound[0]:.4f} ms ({bound[1]}), K2 at {100 * bound[0] / ms:.1f}% of it [{GPU}]")
    shutil.rmtree(index_dir, ignore_errors=True)
    return (err, ms, plain_ms, *bound), launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "lotus_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from lotus_tpu_torch.ops import _kernels
    from lotus_tpu_torch.ops.quant import quantize_rows

    dev = torch.device("cuda")
    t_all = time.perf_counter()

    global GPU
    GPU = card()
    with Phase("device"):
        say(f"  {GPU}; torch {torch.__version__} (CUDA {torch.version.cuda}); "
            f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    with Phase("build kernels (nvcc)"):
        _kernels.lib()
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", _kernels.build_log)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", _kernels.build_log)]
        say(f"  nvcc {_kernels.build_seconds:.2f} s -> {os.path.relpath(_kernels.build(), REPO)}; "
            f"ptxas: {len(regs)} kernels, <= {max(regs, default=0)} registers, "
            f"spill stores {min(spills, default=0)}..{max(spills, default=0)} bytes")
        kernel_report()

    with Phase("K4 vs plain version (a DeepSeek-V2-Lite MoE layer over 64 x 512 tokens)"):
        k4_row, k4_launches = k4_phase(dev)
        rows = {"K4": k4_row}
    torch.cuda.empty_cache()

    with Phase("K6 vs plain version (KDA's recurrence over 8 x 8,192 tokens, 32 heads of 128)"):
        rows["K6"], k6_launches = k6_phase(dev)
    torch.cuda.empty_cache()

    c4_rows, launched = config4_kernels(dev)
    rows.update(c4_rows)
    launched["K4"] = k4_launches
    launched["K6"] = k6_launches
    torch.cuda.empty_cache()

    with Phase("flat corpus"):
        corpus, fq, g = flat_corpus(dev)
        xb16 = corpus.to(torch.bfloat16)
        x8, s8 = quantize_rows(corpus)
        q8, _ = quantize_rows(fq)
        qb = fq.to(torch.bfloat16)
        say(f"  {FLAT_N:,} x 768 rows (bf16 store {xb16.numel() * 2 / 2**30:.2f} GiB), {B} queries")

    with Phase("K2 vs plain version"):
        shape = f"B {B} x {FLAT_N:,} rows x 768"
        k2_int8 = k2_compare(f"int8 store, int8 queries ({shape})", (q8, x8, FLAT_N, s8), exact=True, reps=5)
        k2_main = k2_compare(f"bf16 store ({shape})", (qb, xb16, FLAT_N), exact=False, reps=5)
        k2_compare("int8 store, bf16 queries", (qb, x8, FLAT_N, s8), exact=False)
        k2_compare("f32 store (rounded to bf16)", (qb, corpus, FLAT_N), exact=False)
        k2_f16 = k2_compare(f"f16 store (rounded to bf16; {shape})", (qb, corpus.to(torch.float16), FLAT_N),
                            exact=False, reps=3)
        n_odd = FLAT_N - 1077
        k2_compare(f"int8, n_valid {n_odd:,} (not whole 1024 blocks)", (q8, x8, n_odd, s8), exact=True)
        mask = (torch.rand(FLAT_N, generator=g, device=dev) > 0.1).to(torch.int8)
        for blk in (512, 1024):
            bias = 0.1 * torch.randn((FLAT_N // blk, B), generator=g, device=dev)
            k2_compare(f"int8, bias + row mask, blk {blk}", (q8, x8, FLAT_N, s8, bias, mask),
                       blk=blk, exact=True)
            k2_compare(f"int8 store, bf16 queries, bias + row mask, blk {blk}",
                       (qb, x8, FLAT_N, s8, bias, mask), blk=blk, exact=False)
        del mask, bias
        # A deeper store (d 1536, text-embedding-3-small's width): the query
        # tile no longer fits beside the ring and streams with the stages.
        deep = torch.randn((DEEP_N, 1536), generator=g, device=dev)
        dq = torch.randn((B, 1536), generator=g, device=dev).to(torch.bfloat16)
        k2_compare(f"bf16 store, d 1536 (B {B} x {DEEP_N:,} rows)", (dq, deep.to(torch.bfloat16), DEEP_N),
                   exact=False, reps=3)
        d8, ds8 = quantize_rows(deep)
        k2_compare("int8 store, bf16 queries, d 1536", (dq, d8, DEEP_N, ds8), exact=False)
        k2_compare("int8 store, int8 queries, d 1536", (quantize_rows(dq.float())[0], d8, DEEP_N, ds8), exact=True)
        del deep, dq, d8, ds8
        macs = float(B) * FLAT_N * 768
        say(f"  K2 work: {macs:.4e} MACs per batch -> bf16 {macs / (k2_main[1] * 1e-3) / 1e12:.2f} T FMA/s, "
            f"int8 {2 * macs / (k2_int8[1] * 1e-3) / 1e12:.2f} TOP/s [{GPU}]")
        # K2's bound: the store, the queries and the (B, 256) pool of scores
        # and ids moved once, against 2 * B * N * d operations.
        k2_bounds = {}
        for name, esize, rate, ms in (("bf16", 2, BF16_OPS_PER_S, k2_main[1]),
                                      ("int8", 1, INT8_OPS_PER_S, k2_int8[1]),
                                      ("f16", 2, BF16_OPS_PER_S, k2_f16[1])):
            need = FLAT_N * (768 * esize + (4 if esize == 1 else 0)) + B * 768 * esize + B * 256 * 8
            t_bytes, t_ops = need / HBM_BYTES_PER_S, 2 * macs / rate
            k2_bounds[name] = (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
            say(f"  K2 {name}: bound {k2_bounds[name][0]:.3f} ms ({k2_bounds[name][1]}), K2 {ms:.3f} ms at "
                f"{100 * k2_bounds[name][0] / ms:.1f}% of it [{GPU}]")

        del corpus, xb16, x8, s8, q8, fq, qb
        torch.cuda.empty_cache()
        rows["K2 d1024"], launched["K2"] = k2_store_phase(dev)
    rows.update({"K2": (*k2_main, *k2_bounds["bf16"]), "K2 int8": (*k2_int8, *k2_bounds["int8"]),
                 "K2 f16": (*k2_f16, *k2_bounds["f16"])})

    say(f"total {time.perf_counter() - t_all:.1f} s; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{GPU}]")
    # (row, name, source, what it replaces, launches on a main path: config 4's
    # grouped probe for K1, K3 and K5, the Flat store's call for K2, the MoE
    # layer's forward for K4, a KDA layer's forward for K6); no single PyTorch
    # call does what any of them does, so none has a library time.
    k1, k2 = ("ivf_probe.cu", "lotus_tpu/ops/pallas_ivf.py:235"), ("flat_scan.cu", "lotus_tpu/ops/pallas_flat.py:42")
    table = [
        ("K1", "ivf_probe (K1)", *k1, launched["K1"]),
        ("K2", "flat_scan (K2)", *k2, launched["K2"]),
        # K3 replaces the XLA ops after the probe kernel (no Pallas kernel);
        # K4 a layer the JAX package lacks.
        ("K3", "pool_select (K3)", "pool_select.cu", "lotus_tpu/ops/pallas_ivf.py:558", launched["K3"]),
        ("K4", "moe_combine (K4)", "moe_combine.cu", None, launched["K4"]),
        # K5 replaces the XLA ops before the probe kernel (no Pallas kernel).
        ("K5", "probe_layout (K5)", "probe_layout.cu", "lotus_tpu/ops/pallas_ivf.py:378", launched["K5"]),
        # K6 replaces the plain PyTorch recurrence of a layer the JAX package lacks.
        ("K6", "kda_scan (K6)", "kda_scan.cu", None, launched["K6"]),
        ("K1 bf16 queries", "ivf_probe (K1), bf16 queries on int8 rows", *k1, None),
        ("K1 f16", "ivf_probe (K1), f16 rows under f32 queries", *k1, None),
        ("K1 int8 d770", "ivf_probe (K1), int8 dot at d 770", *k1, None),
        ("K2 int8", "flat_scan (K2), int8 rows and queries", *k2, None),
        ("K2 f16", "flat_scan (K2), f16 rows", *k2, None),
        ("K2 d1024", "flat_scan (K2), f32 rows at d 1024 (a Flat store's call: 256 queries, 10,000 rows, top 100)",
         *k2, None),
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"lotus_tpu_torch/csrc/{src}", "replaces": tpu,
         "launches": launches, "max_abs_err": rows[row][0], "ms": rows[row][1], "plain_ms": rows[row][2],
         "bound_ms": rows[row][3], "bound_by": rows[row][4], "library_ms": None}
        for row, name, src, tpu, launches in table
    ]}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
