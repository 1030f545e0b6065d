"""Kimi-Linear on the card: a KDA layer and a NoPE latent attention layer at
the published widths against the plain reference, the chunked recurrence
(K6, ``csrc/kda_scan.cu``) against its plain version and the token
recurrence at the cell's shape, at a ragged length with right padding, on
one chunk and on arguments it refuses, and a whole forward of the cell's
model free of host synchronisation.

These tests need an NVIDIA GPU and skip without one.  The file imports torch,
the port and the benchmark's reference only, so it runs on a machine without
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kimi_linear_cuda.py
"""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SEED = 2**31 + 24


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _config(**kw) -> dict:
    return {**json.loads((ROOT / "perfbench" / "configs" / "kimi_linear.json").read_text()), **kw}


def _model(cfg: dict, dev: torch.device):
    from perfbench.adapters import _kimi

    return _kimi.build_model(cfg, SEED, dev)


# dtype -> (widest gap relative to each text's largest hidden value, widest
# gap between the pooled, normalised embeddings).  Readings on the card: f32
# 2.8e-6-3.3e-6 and 2.1e-7-4.4e-7; bf16 0.094-0.108 (a token's bf16
# roundings, amplified where the output norm divides a small head output,
# and the rare flip of an expert) and 8.2e-4-2.8e-3.
LAYER_LIMITS = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (0.2, 0.01)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kda_and_nope_mla_layers_match_reference_on_gpu(dtype):
    """Layer 0 (KDA, the dense MLP) and layer 1 (NoPE latent attention, 64 of
    256 sigmoid-routed experts) at the published widths on the card, the
    seeded bf16 weights run in f32 and in bf16, against the plain f32
    reference on four right-padded texts of 8,192, 5,000, 2,100 and 700
    tokens, within ``LAYER_LIMITS``."""
    from perfbench.reference import kimi_linear as ref

    dev = _card()
    cfg = _config(num_hidden_layers=2, linear_attn_config={**_config()["linear_attn_config"], "kda_layers": [1],
                                                            "full_attn_layers": [2]})
    model = _model(cfg, dev).to(dtype)
    lens = [8192, 5000, 2100, 700]
    g = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(0, cfg["vocab_size"], (len(lens), 8192), generator=g, device=dev)
    mask = (torch.arange(8192, device=dev)[None] < torch.tensor(lens, device=dev)[:, None]).long()
    with torch.inference_mode():
        out = model(ids, mask).float()
    plain = ref.PlainKimiLinear(cfg, SEED, dev).hidden([ids[r, :n].tolist() for r, n in enumerate(lens)])
    rel_limit, emb_limit = LAYER_LIMITS[dtype]
    for r, (n, p) in enumerate(zip(lens, plain)):
        rel = float((out[r, :n] - p).abs().max() / p.abs().max())
        e, f = out[r, :n].mean(0), p.mean(0)
        emb = float(torch.linalg.vector_norm(e / e.norm() - f / f.norm()))
        print(f"{dtype} text of {n} tokens: widest relative gap {rel:.3e}, embedding gap {emb:.3e}")
        assert rel <= rel_limit and emb <= emb_limit


@pytest.mark.cuda
def test_chunked_scan_matches_token_recurrence_on_gpu():
    """``kda_scan`` at the cell's shape (8 x 8,192 tokens, 32 heads of 128),
    bf16 q, k and v, seeded decays and decays ten times stronger: within
    2e-6 of the token recurrence on two rows, nothing infinite."""
    from perfbench.reference import kimi_linear as ref

    from lotus_tpu_torch.ops.kda import kda_scan

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(2)
    b, t, h, d = 8, 8192, 32, 128
    q, k = (torch.nn.functional.normalize(torch.randn(b, t, h, d, device=dev, generator=g), dim=-1).bfloat16()
            for _ in range(2))
    v = torch.randn(b, t, h, d, device=dev, generator=g).bfloat16()
    a = 1 + 15 * torch.rand(h, device=dev, generator=g)
    decay = -a.view(h, 1) * torch.nn.functional.softplus(0.2 * torch.randn(b, t, h, d, device=dev, generator=g) - 4)
    beta = torch.rand(b, t, h, device=dev, generator=g)
    with torch.inference_mode():
        for strength in (1.0, 10.0):
            got = kda_scan(q, k, v, strength * decay, beta)
            assert got.shape == (b, t, h, d) and torch.isfinite(got).all()
            want = ref.kda_recurrence(q[::4], k[::4], v[::4], strength * decay[::4], beta[::4])
            err = float((got[::4] - want).abs().max())
            print(f"decays x{strength:g}: widest gap {err:.3e}")
            assert err <= 2e-6


def _scan_rows(b, t, h, strength=1.0, seed=2, dev=None):
    """bf16-sourced q, k (L2-normalised) and v, seeded decays times
    ``strength`` and beta, (b, t, h, 128) and (b, t, h), on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k = (torch.nn.functional.normalize(torch.randn(b, t, h, 128, device=dev, generator=g), dim=-1).bfloat16()
            for _ in range(2))
    v = torch.randn(b, t, h, 128, device=dev, generator=g).bfloat16()
    a = 1 + 15 * torch.rand(h, device=dev, generator=g)
    decay = -a.view(h, 1) * torch.nn.functional.softplus(0.2 * torch.randn(b, t, h, 128, device=dev, generator=g) - 4)
    return q, k, v, strength * decay, torch.rand(b, t, h, device=dev, generator=g)


def _tiles(q, k, v, decay, beta):
    from lotus_tpu_torch.ops import kda

    return [kda.from_rows(x) for x in (q, k, v, decay)] + [kda.from_rows(beta.unsqueeze(-1))]


@pytest.mark.cuda
@pytest.mark.parametrize("strength", [1.0, 10.0], ids=["seeded", "ten_times"])
def test_k6_matches_plain_version_and_token_recurrence_on_gpu(strength):
    """K6 at the cell's shape (8 x 8,192 tokens, 32 heads of 128 = 128
    chunks x 256 tiles), bf16-sourced inputs, seeded decays and ten times
    stronger: two launches, nothing infinite, within 2e-6 of
    ``scan_chunks_reference`` on the same tiles and of the token recurrence
    on two rows."""
    from perfbench.reference import kimi_linear as ref

    from lotus_tpu_torch.ops import kda

    dev = _card()
    rows = _scan_rows(8, 8192, 32, strength, dev=dev)
    tiles = _tiles(*rows)
    with torch.inference_mode():
        launches = kda.scan_chunks.launches
        got = kda.scan_chunks(*tiles)
        assert kda.scan_chunks.launches == launches + kda.K6_LAUNCHES
        assert got.shape == (128, 256, 64, 128) and torch.isfinite(got).all()
        plain = float((got - kda.scan_chunks_reference(*tiles)).abs().max())
        want = ref.kda_recurrence(*(x[::4] for x in rows))
        token = float((kda.to_rows(got, 8, 8192)[::4] - want).abs().max())
    print(f"decays x{strength:g}: K6 against the plain version {plain:.3e}, against the token recurrence {token:.3e}")
    assert plain <= 2e-6 and token <= 2e-6


@pytest.mark.cuda
def test_k6_with_right_padding_and_a_ragged_length_on_gpu():
    """Three rows of 150 tokens (three chunks, the last cut at 22), padded on
    the right after 150, 70 and 129 real tokens: each row's real outputs
    through K6 are its own unpadded token recurrence's, within 2e-6."""
    from perfbench.reference import kimi_linear as ref

    from lotus_tpu_torch.ops import kda

    dev = _card()
    q, k, v, decay, beta = _scan_rows(3, 150, 2, dev=dev)
    with torch.inference_mode():
        got = kda.kda_scan(q, k, v, decay, beta)
        for r, n in enumerate((150, 70, 129)):
            want = ref.kda_recurrence(*(x[r : r + 1, :n] for x in (q, k, v, decay, beta)))
            assert float((got[r : r + 1, :n] - want).abs().max()) <= 2e-6


@pytest.mark.cuda
def test_k6_on_single_chunks_on_gpu():
    """Each chunk of a three-chunk sequence alone (as the state-reset fault
    feeds the wrapper): K6 from a zero state equals the plain version on
    the same one-chunk slice within 2e-6, and differs from the whole
    sequence's outputs after the first chunk."""
    from lotus_tpu_torch.ops import kda

    dev = _card()
    tiles = _tiles(*_scan_rows(2, 192, 3, dev=dev))
    with torch.inference_mode():
        whole = kda.scan_chunks(*tiles)
        for i in range(3):
            one = [x[i : i + 1] for x in tiles]
            got = kda.scan_chunks(*one)
            assert float((got - kda.scan_chunks_reference(*one)).abs().max()) <= 2e-6
            assert (i == 0) == bool(torch.allclose(got, whole[i : i + 1], rtol=0, atol=2e-6))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bf16", "head_dim_64", "transposed", "beta_on_cpu"])
def test_k6_refuses_what_it_does_not_take_on_gpu(case):
    """On the card ``scan_chunks`` launches K6 or raises: another type, head
    size or layout, or a tile on another device, raises ValueError before
    any launch, with no plain fallback."""
    from lotus_tpu_torch.ops import kda

    dev = _card()
    d = 64 if case == "head_dim_64" else 128
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v, decay = (torch.rand(2, 3, d, kda.CHUNK, device=dev, generator=g) for _ in range(4))
    beta = torch.rand(2, 3, 1, kda.CHUNK, device=dev, generator=g)
    if case == "bf16":
        q = q.bfloat16()
    elif case == "transposed":
        v = v.mT.contiguous().mT
    elif case == "beta_on_cpu":
        beta = beta.cpu()
    launches = kda.scan_chunks.launches
    with torch.inference_mode(), pytest.raises(ValueError, match="scan_chunks"):
        kda.scan_chunks(q, k, v, -decay, beta)
    assert kda.scan_chunks.launches == launches


@pytest.mark.cuda
def test_whole_forward_makes_no_sync_on_gpu():
    """The cell's model (27 layers, 64 of 256 experts) queues a whole
    forward without waiting for the card under
    ``torch.cuda.set_sync_debug_mode("error")``, with no exemption, its 20
    KDA layers launching K6's two kernels each; so it does with a profiler
    running, when the spans record events (every ``kda.scan`` with route
    ``kernel``) and the counters add up."""
    from torch.profiler import ProfilerActivity, profile

    from lotus_tpu_torch import profiling
    from lotus_tpu_torch.ops import kda

    dev = _card()
    cfg = _config()
    model = _model(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(3)
    ids = torch.randint(0, cfg["vocab_size"], (2, 4096), generator=g, device=dev)
    mask = torch.ones_like(ids)
    with torch.inference_mode():
        want = model(ids, mask)
        torch.cuda.synchronize()
        launches = kda.scan_chunks.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = model(ids, mask)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.equal(got, want)
        assert kda.scan_chunks.launches - launches == 20 * kda.K6_LAUNCHES
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.cuda.set_sync_debug_mode("error")
            try:
                with profiling.annotate("rm.forward"):
                    model(ids, mask)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    tokens = profiling.counter_totals()["kda.tokens"][:, 0]
    kda_rows = [i - 1 for i in cfg["linear_attn_config"]["kda_layers"]]
    assert tokens[kda_rows].tolist() == [ids.numel() * 32] * 20 and int(tokens.sum()) == ids.numel() * 32 * 20
    totals = profiling.span_totals()
    assert totals["kda.scan"].calls == 20 and totals["kda.scan"].device_s > 0
    assert {r["attrs"]["route"] for r in profiling.span_records() if r["name"] == "kda.scan"} == {"kernel"}
    assert totals["mla.attn"].calls == 7 and totals["moe.experts"].calls == 26
