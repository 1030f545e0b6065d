#!/usr/bin/env python3
"""Smoke run of the lotus_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its seconds):
1. device: require CUDA; print the card's name and power limit;
2. build: compile the CUDA kernels from ``lotus_tpu_torch/csrc`` with nvcc;
3. config 4 build: the seeded 10 * 2**20 x 768 corpus, IVF with nlist 4096,
   residual int8 + int4 refinement, block-aligned at 1024, exact f32 oracle;
4. kernel vs plain: K1 (``probe_fold``) against ``probe_fold_reference`` on
   the card for each variant — int8-dot packed and int8 store with bf16
   queries at the config-4 shape of one 2048-query slice, bf16 packed,
   f32 unpacked and bf16 l2 on the first 512 lists at full width, and int8
   over a window past 8192 rows (unpacked);
5. main path: ``ivf_search_grouped_probe`` at nprobe 208, rescore 24, int8
   queries, query_chunk 2048 over B = 4096; recall@10 against the exact f32
   oracle must reach 0.99; QPS over chained batches;
6. store: ``TorchVS`` indexes 262,144 x 768 seeded vectors (nlist 256,
   block-aligned) and serves a search without ids (through K1) and one with
   ids (only allowed ids come back).

K1's launch count is reset after phase 4 and read after phase 6: the main
path must have launched it.  A last phase times each stage of one 2048-query
slice with CUDA events.  The last three lines are the kernel table, the
card, and ``{"ok": true, "device": {...}}``.  Without a GPU, or without the
repository beside this file, it exits non-zero and prints no result.
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
        say(f"== {self.name}: {self.seconds:.3f} s" + ("" if exc[0] is None else " (FAILED)"))
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


def compare(name, args, *, bl, int8_dot, l2, packed, exact, tol=0.0, reps=0):
    """Run K1 and its plain version on the same card tensors and hold them
    together; returns (max_abs_err, kernel ms, plain ms)."""
    import torch

    from lotus_tpu_torch.ops.ivf_probe import _LOCAL_MASK, probe_fold, probe_fold_reference

    kw = dict(bl=bl, int8_dot=int8_dot, l2=l2, packed=packed)
    got_s, got_i = probe_fold(*args, **kw)
    torch.cuda.synchronize()
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
        + ("" if ms is None else f"; K1 {ms:.3f} ms vs plain {plain_ms:.3f} ms"))
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version: {name}")
    return err, ms, plain_ms


def stage_breakdown(state, queries, gpu: str) -> None:
    """Device ms of each stage of one query_chunk slice, each stage run on
    its own between CUDA events (torch.profiler's CUDA tracing crashes the
    process on the chip machine, so there is no per-kernel trace)."""
    import torch

    from lotus_tpu_torch.ops.flat import flat_search
    from lotus_tpu_torch.ops.ivf import rescore_candidates
    from lotus_tpu_torch.ops.ivf_probe import ivf_search_grouped_probe, probe_fold, probe_layout
    from lotus_tpu_torch.ops.quant import quantize_rows

    q = queries[:QUERY_CHUNK]
    bl = int(state["meta"]["block_align"])
    _, lists = flat_search(state["centroids"], q, NPROBE, metric="ip")
    lists = lists.to(torch.int32)
    units, chunk_list, _, _ = probe_layout(lists, quantize_rows(q)[0], state["ivf_list_size"], bl)
    _, cand = ivf_search_grouped_probe(state, q, RESCORE, nprobe=NPROBE, int8_queries=True)
    stages = {
        "coarse ranking (flat_search over centroids)":
            lambda: flat_search(state["centroids"], q, NPROBE, metric="ip"),
        "query quantization + probe_layout":
            lambda: probe_layout(lists, quantize_rows(q)[0], state["ivf_list_size"], bl),
        "K1 probe_fold": lambda: probe_fold(
            units, state["ivf_vectors"], state["ivf_row_scales"], None, chunk_list,
            state["ivf_list_start"], state["ivf_list_size"], bl=bl, int8_dot=True, l2=False, packed=True),
        "exact rescore (24 -> 10)": lambda: rescore_candidates(state, q, cand, K),
        "whole slice (ivf_search_grouped_probe)": lambda: ivf_search_grouped_probe(
            state, q, K, nprobe=NPROBE, rescore=RESCORE, int8_queries=True),
    }
    times = {name: cuda_ms(fn, 5) for name, fn in stages.items()}
    whole = times.pop("whole slice (ivf_search_grouped_probe)")
    rest = whole - sum(times.values())
    say(f"  stage breakdown of one {QUERY_CHUNK}-query slice, device ms (CUDA events) [{gpu}]:")
    for name, ms in [*times.items(), ("reassembly, pool top-k, scale (the rest)", rest)]:
        say(f"    {ms:9.3f} ms {100 * ms / whole:5.1f}%  {name}")
    say(f"    {whole:9.3f} ms 100.0%  whole slice")


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
    from lotus_tpu_torch.ops.bench_data import corpus_centers, gen_chunk, synth_ivf_device_build
    from lotus_tpu_torch.ops.flat import flat_search
    from lotus_tpu_torch.ops.ivf_probe import (
        LOCAL_BITS, QU, ivf_search_grouped_probe, probe_fold, probe_fold_reference, probe_layout,
    )
    from lotus_tpu_torch.ops.quant import quantize_rows

    dev = torch.device("cuda")
    t_all = time.perf_counter()

    with Phase("device"):
        gpu = card()
        say(f"  {gpu}; torch {torch.__version__} (CUDA {torch.version.cuda}); "
            f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    with Phase("build kernels (nvcc)"):
        _kernels.lib()
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", _kernels.build_log)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", _kernels.build_log)]
        say(f"  nvcc {_kernels.build_seconds:.2f} s -> {os.path.relpath(_kernels.build(), REPO)}; "
            f"ptxas: {len(regs)} kernels, <= {max(regs, default=0)} registers, "
            f"spill stores {min(spills, default=0)}..{max(spills, default=0)} bytes")

    with Phase("config 4 build"):
        torch.cuda.reset_peak_memory_stats()
        built = synth_ivf_device_build(
            n=10 * 2**20, d=768, nlist=4096, n_clusters=65536, cluster_scale=2.5, chunk=2**18,
            queries_b=B, gt_queries=256, k=K, block_align=1024, seed=0, device=dev, log=say,
        )
        state, xq, gt = built["state"], built["queries"], built["gt"]
        meta = state["meta"]
        say(f"  build {built['build_seconds']:.2f} s = {built['build_vecs_per_s']:,.0f} vecs/s; phases "
            + ", ".join(f"{k} {v:.2f} s" for k, v in built["timings"].items())
            + f"; window {meta['probe_window']}; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{gpu}]")

    with Phase("kernel vs plain version"):
        bl = int(meta["block_align"])
        vecs, scales = state["ivf_vectors"], state["ivf_row_scales"]
        starts, sizes = state["ivf_list_start"], state["ivf_list_size"]
        q = xq[:QUERY_CHUNK]
        _, lists = flat_search(state["centroids"], q, NPROBE, metric="ip")
        packed_main = int(meta["probe_window"]) <= (1 << LOCAL_BITS)
        units, chunk_list, _, _ = probe_layout(lists.to(torch.int32), quantize_rows(q)[0], sizes, bl)
        live = chunk_list[chunk_list >= 0].long()
        macs = float(QU * 768 * (((sizes[live].double() + 63) // 64) * 64).sum())
        main_err, main_ms, main_plain_ms = compare(
            f"int8-dot {'packed' if packed_main else 'unpacked'} (config 4, {QUERY_CHUNK} queries)",
            (units, vecs, scales, None, chunk_list, starts, sizes), bl=bl, int8_dot=True, l2=False,
            packed=packed_main, exact=True, reps=10,
        )
        say(f"  K1 work: {macs:.4e} int8 MACs in {int(live.numel())} live chunks -> "
            f"{2 * macs / (main_ms * 1e-3) / 1e12:.1f} TOP/s [{gpu}]")
        units_bf, _, _, _ = probe_layout(lists.to(torch.int32), q.to(torch.bfloat16), sizes, bl)
        compare("int8 store, bf16 queries (dequant), config 4",
                (units_bf, vecs, scales, None, chunk_list, starts, sizes), bl=bl, int8_dot=False,
                l2=False, packed=packed_main, exact=False, tol=2e-3)
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
        ):
            units_s, cl_s, _, _ = probe_layout(sub_lists, xq[:512].to(qdt), sub[1], bl)
            norms = (xs.float() ** 2).sum(1) if l2 else None
            compare(name, (units_s, xs, None, norms, cl_s, *sub), bl=bl, int8_dot=False, l2=l2,
                    packed=packed, exact=False, tol=1e-4 if not packed else 2e-3)
        del xf

        # A window past 8192 rows: lists of 12 blocks (unpacked, ids compared).
        span = 12 * bl
        nwin = 10
        w_starts = torch.arange(0, nwin * span, span, dtype=torch.int32, device=dev)
        w_sizes = (span - torch.tensor([0, 5, 100, 1023, 1024, 3000, 7, 0, 64, 65],
                                       dtype=torch.int32, device=dev)).contiguous()
        w_lists = torch.argsort(torch.rand((256, nwin), generator=g, device=dev), dim=1)[:, :4].to(torch.int32)
        units_w, cl_w, _, _ = probe_layout(w_lists, quantize_rows(xq[:256])[0], w_sizes, bl)
        compare("int8-dot, window 12288 rows (unpacked)",
                (units_w, vecs, scales, None, cl_w, w_starts, w_sizes), bl=bl, int8_dot=True, l2=False,
                packed=False, exact=True)

    probe_fold.launches = 0  # count only the main path's launches from here
    with Phase("config 4 search"):
        def search(queries):
            return ivf_search_grouped_probe(
                state, queries, K, nprobe=NPROBE, metric="ip", rescore=RESCORE, int8_queries=True,
                query_chunk=QUERY_CHUNK,
            )

        dists, ids = search(xq)
        torch.cuda.synchronize()
        launches_search = probe_fold.launches
        got = ids[: gt.shape[0]].cpu().numpy()
        recall = float(sum(len(set(got[i]) & set(gt[i])) for i in range(gt.shape[0])) / (K * gt.shape[0]))
        finite = bool(torch.isfinite(dists).all()) and tuple(ids.shape) == (B, K)
        iters, per_call = 3, float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                search(xq)
            torch.cuda.synchronize()
            per_call = min(per_call, (time.perf_counter() - t0) / iters)
        qps = B / per_call
        say(f"  recall@{K} vs exact f32 = {recall!r} over {gt.shape[0]} queries; finite {finite}; "
            f"K1 launches {launches_search}")
        say(f"  QPS {qps:,.1f} (B={B}, nprobe={NPROBE}, rescore={RESCORE}, int8 queries, "
            f"query_chunk={QUERY_CHUNK}; {per_call * 1e3:.2f} ms per batch) "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{gpu}]")
        assert finite, "search output is not finite or has the wrong shape"
        assert recall >= 0.99, f"recall@10 {recall} below the 0.99 target"
        assert launches_search > 0, "the main path did not launch K1"

    with Phase("store entry point (TorchVS)"):
        from lotus_tpu_torch import TorchVS
        from lotus_tpu_torch.ops.io import read_meta

        n_store = 262_144
        centers = corpus_centers(7, 4096, 768, dev)
        emb_t = gen_chunk(7, 0, centers, n_store, 2.5)
        emb = emb_t.cpu().numpy()
        index_dir = os.path.join(REPO, "build", "lotus_tpu_torch", "smoke_index")
        shutil.rmtree(index_dir, ignore_errors=True)
        vs = TorchVS(index_type="ivf", device_dtype="int8", int8_refine=True, rescore=RESCORE, nlist=256)
        t0 = time.perf_counter()
        vs.index([], emb, index_dir)
        say(f"  index() {time.perf_counter() - t0:.2f} s; block_align {read_meta(index_dir)['block_align']}")
        g = torch.Generator(device=dev).manual_seed(11)
        qs = emb_t[:256] + 0.05 * torch.randn((256, 768), generator=g, device=dev)
        qs = (qs / torch.linalg.vector_norm(qs, dim=1, keepdim=True))
        before = probe_fold.launches
        out = vs(qs.cpu().numpy(), K)
        store_launches = probe_fold.launches - before
        exact = torch.topk(qs @ emb_t.T, K, dim=1).indices.cpu().numpy()
        got = out.indices
        store_recall = sum(len(set(got[i]) & set(exact[i].tolist())) for i in range(256)) / (256 * K)
        allowed = sorted(torch.randperm(n_store, generator=torch.Generator().manual_seed(3))[:1000].tolist())
        sub_out = vs(qs[:4].cpu().numpy(), K, ids=allowed)
        allowed_set = set(allowed)
        only_allowed = all(i in allowed_set or i == -1 for row in sub_out.indices for i in row)
        say(f"  search without ids: recall@{K} vs exact f32 = {store_recall!r}, K1 launches {store_launches}; "
            f"with ids: only allowed ids {only_allowed}; stats {vs.stats}")
        shutil.rmtree(index_dir, ignore_errors=True)
        assert store_launches > 0, "TorchVS did not reach K1"
        assert only_allowed, "ids-restricted search returned an id outside ids"

    launches = probe_fold.launches  # the main path's launches: search, QPS runs, store

    with Phase("stage breakdown"):
        stage_breakdown(state, xq, gpu)
    del state, built

    say(f"total {time.perf_counter() - t_all:.1f} s; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(json.dumps({"kernels": [{
        "name": "ivf_probe (K1)",
        "route": "cuda",
        "source": "lotus_tpu_torch/csrc/ivf_probe.cu",
        "replaces": "lotus_tpu/ops/pallas_ivf.py:235",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": main_ms,
        "plain_ms": main_plain_ms,
    }]}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
