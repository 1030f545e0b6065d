"""DeepSeek-V3.2-Exp on the card: a dense and an MoE layer at the published
widths against the plain reference, f32 products of half-precision operands,
the indexer's selection at the cell's length against its own f32 formula,
and a whole forward of the cell's model (8 layers, 8 of 256 experts, one
document of 32,768 tokens) free of host synchronisation.

These tests need an NVIDIA GPU and skip without one.  The file imports torch,
the port and the benchmark's reference only, so it runs on a machine without
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_deepseek_v32_cuda.py
"""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SEED = 2**31 + 26


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _config(**kw) -> dict:
    return {**json.loads((ROOT / "perfbench" / "configs" / "dsv32_exp.json").read_text()), **kw}


def _model(cfg: dict, dev: torch.device):
    from perfbench.adapters import _dsv32

    return _dsv32.build_model(cfg, SEED, dev)


# dtype -> (widest gap relative to each text's largest hidden value, median
# over a text's tokens of the relative L2 gap, widest gap between the
# pooled, normalised embeddings).  Readings on the card at 4,096 tokens: f32
# 3.9e-2, 7.6e-6 and 1.4e-4 (the widest is a token whose expert choice
# flips on a near tie of the group-limited router, the rounding of one
# summation order against another); bf16 0.22, 0.015 and 8.4e-3 (6.5e-3 at
# 3,000 tokens).
LAYER_LIMITS = {torch.float32: (0.2, 1e-4, 1e-3), torch.bfloat16: (0.5, 0.03, 0.02)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dense_and_moe_layers_match_reference_on_gpu(dtype):
    """Layer 0 (the dense MLP) and layer 1 (8 of 256 group-routed experts)
    at the published widths on the card, each with the query LoRA, the
    indexer keeping 2,048 keys a query and sparse latent attention, the
    seeded bf16 weights run in f32 and in bf16, against the plain f32
    reference on two right-padded texts of 4,096 and 3,000 tokens, within
    ``LAYER_LIMITS``."""
    from perfbench.reference import deepseek_v32 as ref

    dev = _card()
    cfg = _config(num_hidden_layers=2, first_k_dense_replace=1)
    model = _model(cfg, dev).to(dtype)
    lens = [4096, 3000]
    g = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(0, cfg["vocab_size"], (len(lens), 4096), generator=g, device=dev)
    mask = (torch.arange(4096, device=dev)[None] < torch.tensor(lens, device=dev)[:, None]).long()
    with torch.inference_mode():
        out = model(ids, mask).float()
    plain = ref.PlainDeepseekV32(cfg, SEED, dev).hidden([ids[r, :n].tolist() for r, n in enumerate(lens)])
    widest, typical, emb_limit = LAYER_LIMITS[dtype]
    for r, (n, p) in enumerate(zip(lens, plain)):
        rel = float((out[r, :n] - p).abs().max() / p.abs().max())
        med = float((torch.linalg.vector_norm(out[r, :n] - p, dim=-1) / torch.linalg.vector_norm(p, dim=-1)).median())
        e, f = out[r, :n].mean(0), p.mean(0)
        emb = float(torch.linalg.vector_norm(e / e.norm() - f / f.norm()))
        print(f"{dtype} text of {n} tokens: widest relative gap {rel:.3e}, median {med:.3e}, embedding gap {emb:.3e}")
        assert rel <= widest and med <= typical and emb <= emb_limit


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
def test_f32_products_of_half_operands_on_gpu(dtype):
    """``dsa.f32_matmul`` on the card (cuBLAS with an f32 output) gives the
    f32 products of the half-precision operands, 2-D and batched, within
    f32 rounding of the exact ones computed from their f32 copies."""
    from lotus_tpu_torch.ops import dsa

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(2)
    a, b = torch.randn(300, 128, generator=g, device=dev), torch.randn(128, 500, generator=g, device=dev)
    cases = [(a.to(dtype), b.to(dtype)), (a.view(3, 100, 128).to(dtype), b[None, :, :100].expand(3, 128, 100).to(dtype))]
    for x, y in cases:
        got = dsa.f32_matmul(x, y)
        want = x.double() @ y.double()
        assert got.dtype == torch.float32
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-6


@pytest.mark.cuda
def test_index_selection_at_the_cells_length_on_gpu():
    """``dsa.index_topk`` at the cell's shape (32,768 tokens, 64 heads of
    128, top 2,048) on bf16 queries and keys: on 64 sampled rows its
    selection is the top-2,048 of the same scores computed row by row in
    f64 from the same bf16 values (up to summation-order ties: at least
    99.9% shared a row), and the first 2,048 rows keep every earlier key."""
    from lotus_tpu_torch.ops import dsa

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(3)
    s, heads, d, k = 32768, 64, 128, 2048
    q = torch.randn(1, s, heads, d, generator=g, device=dev).bfloat16()
    keys = torch.randn(1, s, d, generator=g, device=dev).bfloat16()
    w = torch.randn(1, s, heads, generator=g, device=dev) * (heads * d) ** -0.5
    with torch.inference_mode():
        idx = dsa.index_topk(q, keys, w, k)
    assert idx.shape == (1, s, k)
    rows = torch.randint(k, s, (64,), generator=g, device=dev).tolist()
    worst = 1.0
    for t in rows:
        scores = (torch.relu(q[0, t].double() @ keys[0, : t + 1].double().T) * w[0, t, :, None].double()).sum(0)
        want = torch.topk(scores, k).indices
        shared = torch.isin(idx[0, t], want).sum().item() / k
        worst = min(worst, shared)
        assert int(idx[0, t].max()) <= t
    print(f"index selection at 32,768 tokens: least share of the f64 top-2,048 kept {worst:.5f}")
    assert worst >= 0.999
    early = idx[0, :k]
    later = early > torch.arange(k, device=dev)[:, None]
    assert bool(((~later).sum(1) == torch.arange(1, k + 1, device=dev)).all())


@pytest.mark.cuda
def test_whole_forward_makes_no_sync_on_gpu():
    """The cell's model (layers 0-7, 8 of 256 experts) queues a whole forward
    of one 32,768-token document without waiting for the card under
    ``torch.cuda.set_sync_debug_mode("error")``, with no exemption, the same
    bits twice; so it does with a profiler running, when the spans record
    events and the counters add up to every layer's causal pairs, selected
    pairs and rows.  Prints the forward's time and its split by span."""
    from torch.profiler import ProfilerActivity, profile

    from lotus_tpu_torch import profiling
    from lotus_tpu_torch.ops import dsa

    dev = _card()
    cfg = _config()
    model = _model(cfg, dev)
    s, layers, topk = 32768, cfg["num_hidden_layers"], cfg["index_topk"]
    g = torch.Generator(device=dev).manual_seed(4)
    ids = torch.randint(0, cfg["vocab_size"], (1, s), generator=g, device=dev)
    mask = torch.ones_like(ids)
    with torch.inference_mode():
        want = model(ids, mask)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.set_sync_debug_mode("error")
        try:
            start.record()
            got = model(ids, mask)
            end.record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        print(f"a forward of 1 x {s}: {start.elapsed_time(end):.1f} ms, peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.cuda.set_sync_debug_mode("error")
            try:
                with profiling.annotate("rm.forward"):
                    model(ids, mask)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    counters = profiling.counter_totals()
    want_counts = {"dsa.scored": s * (s + 1) // 2, "dsa.pairs": dsa.causal_selections(s, topk), "dsa.queries": s}
    for name, n in want_counts.items():
        assert counters[name][:, 0].tolist() == [n] * layers, name
    totals = profiling.span_totals()
    for name, t in sorted(totals.items(), key=lambda x: -x[1].device_s):
        print(f"{name}: {t.calls} calls, {1e3 * t.device_s:.1f} device ms")
    assert totals["dsa.index"].calls == totals["dsa.attn"].calls == totals["mla.attn"].calls == layers
    assert totals["dsa.index"].device_s > 0 and totals["moe.experts"].calls == 5
