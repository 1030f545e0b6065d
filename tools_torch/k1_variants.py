#!/usr/bin/env python3
"""What bounds K1 on the card: variants of ``csrc/ivf_probe.cu`` with parts
removed, built side by side and timed in one process on one config-4 slice.

    python3 tools_torch/k1_variants.py

Each variant, of the int8-dot path and of bf16 queries on the int8 rows,
is the kernel source with text substitutions (where the row
scales come from, the fold, the wgmma, the ring's stage size), compiled with the
package's nvcc flags under ``build/k1_variants/`` and linked with the
other kernels' objects into its own library, which ``probe_fold`` then
launches.  Only the
unchanged build is checked against the plain version; the others compute
something else and are timed only.  The timings run in turns (the unchanged
build first and last).  Needs one NVIDIA GPU and the CUDA toolkit.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# name -> (what it shows, [(text in ivf_probe.cu, replacement)])
VARIANTS = {
    "built": ("the kernel as built", []),
    "scales from L2": ("the epilogue loads the row scales from device memory (L2) instead of the "
                       "slice-info ring",
                       [("fac = *reinterpret_cast<const float2*>(si + col);",
                         "fac = __ldg(reinterpret_cast<const float2*>(scales + row0 + col));")]),
    "no scales": ("the epilogue's row scales replaced by 1",
                  [("fac = *reinterpret_cast<const float2*>(si + col);", "fac = make_float2(1.f, 1.f);")]),
    "no fold": ("no epilogue: the wgmma loop and the ring alone",
                [("for (int j = 0; j < 8; ++j) {\n      const int col = 8 * j + 2 * (l & 3);\n      float2 fac",
                  "for (int j = 0; j < 0; ++j) {\n      const int col = 8 * j + 2 * (l & 3);\n      float2 fac")]),
    "no wgmma": ("no wgmma: the ring's stream, its handshake and the fold",
                 [("stage_mma<N, INT8_DOT>(acc, q0, sa, k0 == 0);", "")]),
    "stream only": ("neither wgmma nor fold: the ring's stream and handshake alone",
                    [("stage_mma<N, INT8_DOT>(acc, q0, sa, k0 == 0);", ""),
                     ("for (int j = 0; j < 8; ++j) {\n      const int col = 8 * j + 2 * (l & 3);\n      float2 fac",
                      "for (int j = 0; j < 0; ++j) {\n      const int col = 8 * j + 2 * (l & 3);\n      float2 fac")]),
    "half-slice stages": ("two stages a slice: 4 stages of 24 KB instead of 2 of 48 KB",
                          [("  int sps = 1;\n", "  int sps = 2;\n")]),
}
# The same for bf16 queries on the int8 rows (raw rows converted by the
# producer, the query tile streamed with the stages).
BF16_VARIANTS = {
    "built": ("the kernel as built", []),
    "raw ring of 8": ("8 raw chunk slots (32 KB in flight) instead of 4; stages of 3 chunk pairs",
                      [("constexpr int RAW = 4;", "constexpr int RAW = 8;")]),
    "no conversion": ("the raw int8 bytes copied into the stage without conversion",
                      [("*swizzled(part, r, u) = int8x8_to_bf16(v.x, v.y);",
                        "*swizzled(part, r, u) = make_uint4(v.x, v.y, 0u, 0u);")]),
    "4 stages of 2 pairs": ("stages of 2 depth-chunk pairs (48 KB), a ring of 4 instead of 2 of 96 KB",
                            [("  int sps = 1;\n", "  int sps = 6;\n")]),
    "4 x 2 pairs, raw 8": ("the same with 8 raw chunk slots",
                           [("  int sps = 1;\n", "  int sps = 6;\n"),
                            ("constexpr int RAW = 4;", "constexpr int RAW = 8;")]),
    "8 stages of 1 pair": ("stages of one depth-chunk pair (24 KB), a ring of 8",
                           [("  int sps = 1;\n", "  int sps = 12;\n"),
                            ("constexpr int MAX_STAGES = 4;", "constexpr int MAX_STAGES = 8;")]),
    "query not streamed": ("the stages carry no query chunks (the wgmma reads stale ones)",
                           [("          if (qstream) {\n            mbar_arrive_tx(&full[stage], qbytes);",
                             "          if (false) {\n            mbar_arrive_tx(&full[stage], qbytes);")]),
}


def build_variants(out: Path, variants: dict) -> dict[str, Path]:
    """Compile every variant (one nvcc each, all started together) and
    return the library path of each."""
    from lotus_tpu_torch.ops import _kernels

    out.mkdir(parents=True, exist_ok=True)
    src = (_kernels.SRC_DIR / "ivf_probe.cu").read_text()
    nvcc = _kernels.cuda_tool("nvcc")
    inc = ["-I", str(_kernels.SRC_DIR)]
    # The other kernels' sources, linked into every variant: ``_kernels.bind``
    # declares the whole library's interface.
    others = sorted(p for p in _kernels.SRC_DIR.glob("*.cu") if p.name != "ivf_probe.cu")
    jobs = {p.stem: subprocess.Popen([nvcc, *_kernels.NVCC_FLAGS, *inc, "-c", "-o", str(out / f"{p.stem}.o"), str(p)],
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for p in others}
    for i, (name, (_, subs)) in enumerate(variants.items()):
        text = src
        for a, b in subs:
            assert text.count(a) == 1, f"{name}: {a!r} is not in ivf_probe.cu once"
            text = text.replace(a, b)
        (out / f"v{i}.cu").write_text(text)
        jobs[name] = subprocess.Popen([nvcc, *_kernels.NVCC_FLAGS, *inc, "-c", "-o", str(out / f"v{i}.o"),
                                       str(out / f"v{i}.cu")],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in jobs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    libs = {}
    for i, name in enumerate(variants):
        lib = out / f"lib_v{i}.so"
        subprocess.run([nvcc, *_kernels.ARCH, "-shared", "-o", str(lib), str(out / f"v{i}.o"),
                        *(str(out / f"{p.stem}.o") for p in others)], check=True, capture_output=True)
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_variants: needs a CUDA GPU", file=sys.stderr)
        return 1
    from lotus_tpu_torch.ops import _kernels
    from lotus_tpu_torch.ops.bench_data import synth_ivf_device_build
    from lotus_tpu_torch.ops.flat import flat_search
    from lotus_tpu_torch.ops.ivf_probe import probe_fold, probe_fold_reference, probe_layout
    from lotus_tpu_torch.ops.quant import quantize_rows

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    libs = build_variants(REPO / "build" / "k1_variants", VARIANTS)
    bf_libs = build_variants(REPO / "build" / "k1_variants_bf16", BF16_VARIANTS)
    print(f"built {len(libs) + len(bf_libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)

    dev = torch.device("cuda")
    built = synth_ivf_device_build(n=10 * 2**20, d=768, nlist=4096, n_clusters=65536, cluster_scale=2.5,
                                   chunk=2**18, queries_b=4096, gt_queries=16, k=10, block_align=1024,
                                   seed=0, device=dev)
    state, xq = built["state"], built["queries"][:2048]  # chip_smoke.py's first slice
    bl = int(state["meta"]["block_align"])
    _, lists = flat_search(state["centroids"], xq, 208, metric="ip")
    units, chunk_list, _, _ = probe_layout(lists.to(torch.int32), quantize_rows(xq)[0],
                                           state["ivf_list_size"], bl)
    args = (units, state["ivf_vectors"], state["ivf_row_scales"], None, chunk_list,
            state["ivf_list_start"], state["ivf_list_size"])
    kw = dict(bl=bl, int8_dot=True, l2=False, packed=True)
    units_bf, _, _, _ = probe_layout(lists.to(torch.int32), xq.to(torch.bfloat16), state["ivf_list_size"], bl)
    args_bf = (units_bf, *args[1:])
    kw_bf = dict(kw, int8_dot=False)

    def timed(lib: Path, args, kw, reps: int = 10) -> float:
        _kernels._lib = _kernels.bind(lib)
        probe_fold(*args, **kw)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            probe_fold(*args, **kw)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    _kernels._lib = _kernels.bind(libs["built"])
    got = probe_fold(*args, **kw)[0]
    ref = probe_fold_reference(*args, **kw)[0]
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), "the unchanged build disagrees"
    print(f"config-4 slice: 2048 queries x nprobe 208, int8-dot packed; unchanged build bit-equal "
          f"to the plain version; {card}", flush=True)
    for title, variants, built_libs, a, k in (("int8-dot packed", VARIANTS, libs, args, kw),
                                              ("bf16 queries, packed", BF16_VARIANTS, bf_libs, args_bf, kw_bf)):
        order = ["built", *[n for n in variants if n != "built"], "built"]
        times: dict[str, list[float]] = {}
        for name in order:
            times.setdefault(name, []).append(timed(built_libs[name], a, k))
        print(f" {title}:", flush=True)
        for name in variants:
            ms = ", ".join(f"{t:.3f}" for t in times[name])
            print(f"  {name:18s} {ms} ms  ({variants[name][0]})", flush=True)
    _kernels._lib = None
    return 0


if __name__ == "__main__":
    os.chdir(REPO)
    sys.exit(main())
