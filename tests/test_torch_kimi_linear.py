"""Kimi-Linear (``lotus_tpu_torch/models/kimi_linear.py``) and its KDA
recurrence (``lotus_tpu_torch/ops/kda.py``) on the CPU, at a small config
with seeded weights (one period: 3 KDA layers, the first dense, and 1 NoPE
latent attention layer; 8 sigmoid-routed experts, top 2, 1 shared): against
the benchmark's plain reference (``perfbench/reference/kimi_linear.py``) in
f32 and bf16, the reference's recurrence and router against
``transformers``', the chunked recurrence against the token recurrence, the
expert shares, DeepSeek-V2's path unchanged, planted faults, the checkpoint
loader, and the cost of the spans and the counter with no profiler
running."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from perfbench import bpe_files, texts  # noqa: E402
from perfbench.reference import deepseek_v2 as ref_dsv2  # noqa: E402
from perfbench.reference import kimi_linear as ref  # noqa: E402
from perfbench.reference.bpe import ByteBPE  # noqa: E402

from lotus_tpu_torch import profiling  # noqa: E402
from lotus_tpu_torch.models import TorchSentenceEncoderRM  # noqa: E402
from lotus_tpu_torch.models import deepseek_v2 as dsv2  # noqa: E402
from lotus_tpu_torch.models import kimi_linear as kimi  # noqa: E402
from lotus_tpu_torch.models.checkpoint import FAMILIES, fit_state_dict  # noqa: E402
from lotus_tpu_torch.ops import kda  # noqa: E402

CFG = dict(model_type="kimi_linear", vocab_size=320, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
           num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=4, num_experts=8,
           num_experts_per_token=2, num_shared_experts=1, first_k_dense_replace=1, moe_layer_freq=1,
           moe_renormalize=True, moe_router_activation_func="sigmoid", num_expert_group=1, topk_group=1,
           use_grouped_topk=True, routed_scaling_factor=2.446, q_lora_rank=None, kv_lora_rank=32,
           qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32, mla_use_nope=True, rope_scaling=None,
           rms_norm_eps=1e-5, hidden_act="silu", tie_word_embeddings=False,
           linear_attn_config={"full_attn_layers": [4], "kda_layers": [1, 2, 3], "head_dim": 16, "num_heads": 4,
                               "short_conv_kernel_size": 4})
SEED = 2**31 + 2424
LENS = [150, 77, 130]  # right-padded to 160 in one batch, none a whole number of 64-token chunks
CPU = torch.device("cpu")
KDA_LAYERS, MOE_LAYERS = 3, 3


def port(dtype=torch.float32, cfg=CFG, seed=SEED, **kw):
    """The port's model with the reference's seeded weights, loaded under the
    checkpoint's names."""
    weights = ref.model_weights(cfg, seed, CPU, dtype)
    with torch.device("meta"):
        model = kimi.KimiLinearModel(kimi.KimiLinearConfig.from_dict(cfg), **kw)
    return fit_state_dict(model, {"model." + k: v.clone() for k, v in weights.items()}).eval()


def batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, CFG["vocab_size"], (len(LENS), 160), generator=g)
    mask = torch.zeros(len(LENS), 160, dtype=torch.int64)
    for r, n in enumerate(LENS):
        mask[r, :n] = 1
    return ids, mask


def reference_hidden(dtype=torch.float32, cfg=CFG, seed=SEED):
    ids, _ = batch()
    return ref.PlainKimiLinear(cfg, seed, CPU, dtype).hidden([ids[r, :n].tolist() for r, n in enumerate(LENS)])


def worst_rel(model, plain) -> float:
    """Widest gap between the port's last hidden state and the reference's,
    over each text's real tokens, relative to the text's largest value."""
    ids, mask = batch()
    with torch.no_grad():
        out = model(ids, mask).float()
    return max(float((out[r, :n] - p).abs().max() / p.abs().max()) for r, (n, p) in enumerate(zip(LENS, plain)))


@pytest.fixture(scope="module")
def plain_f32():
    return reference_hidden()


def test_port_matches_reference_in_f32(plain_f32):
    assert worst_rel(port(), plain_f32) <= 1e-5


def test_port_in_bf16_within_tolerance():
    """bf16 keeps 8 bits of mantissa, a layer rounds each product's inputs
    and outputs a dozen times, and a rounding can flip a token's choice
    among the sigmoid scores: over five seeds the four layers read
    0.018-0.041 of the largest value; 0.06 leaves room at this size."""
    plain = reference_hidden(torch.bfloat16)
    assert worst_rel(port(torch.bfloat16), plain) <= 0.06


def _l2(x):
    return x / torch.sqrt(x.pow(2).sum(-1, keepdim=True) + 1e-6)


def test_reference_recurrence_matches_transformers_gated_delta_rule():
    """With one decay for all of a head's channels, the reference's token
    recurrence is ``transformers``' gated delta rule (Qwen3-Next's
    ``torch_recurrent_gated_delta_rule``, q and k L2-normalised in it)."""
    pytest.importorskip("transformers")
    from transformers.models.qwen3_next.modeling_qwen3_next import torch_recurrent_gated_delta_rule

    g = torch.Generator().manual_seed(5)
    b, t, h, d = 2, 40, 3, 16
    q, k, v = (torch.randn(b, t, h, d, generator=g) for _ in range(3))
    decay = -torch.rand(b, t, h, generator=g) * 2
    beta = torch.rand(b, t, h, generator=g)
    want, _ = torch_recurrent_gated_delta_rule(q, k, v, decay, beta, None, False, use_qk_l2norm_in_kernel=True)
    got = ref.kda_recurrence(_l2(q), _l2(k), v, decay[..., None].expand(b, t, h, d), beta)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_reference_router_matches_transformers_deepseek_v3():
    """The reference's sigmoid router (scores plus the correction bias
    choose, the uncorrected scores renormalised and scaled weigh) is
    ``transformers``' ``DeepseekV3TopkRouter`` with one group, and so is the
    port's ``DeepseekV2MoE.route``."""
    transformers = pytest.importorskip("transformers")
    if not hasattr(transformers, "DeepseekV3Config"):
        pytest.skip("this transformers has no DeepseekV3Config")
    from transformers.models.deepseek_v3.modeling_deepseek_v3 import DeepseekV3TopkRouter

    w = ref.layer_weights(CFG, SEED, 1, CPU, torch.float32)
    hf_cfg = transformers.DeepseekV3Config(n_routed_experts=8, num_experts_per_tok=2, n_group=1, topk_group=1,
                                           norm_topk_prob=True, routed_scaling_factor=2.446, hidden_size=64)
    router = DeepseekV3TopkRouter(hf_cfg)
    router.weight.data.copy_(w["mlp.gate.weight"])
    router.e_score_correction_bias.copy_(w["mlp.gate.e_score_correction_bias"])
    x = torch.randn(50, 64, generator=torch.Generator().manual_seed(6))
    want_i, want_w = router(x)
    order = torch.argsort(want_i, dim=-1)
    want_i, want_w = want_i.gather(1, order), want_w.gather(1, order)
    got_i, got_w = ref.PlainKimiLinear(CFG, SEED, CPU).route(x, w)
    order = torch.argsort(got_i, dim=-1)
    assert torch.equal(got_i.gather(1, order), want_i)
    torch.testing.assert_close(got_w.gather(1, order), want_w, rtol=1e-6, atol=1e-7)
    moe, _ = _moe_layer()
    weights, sorted_pairs, offsets, _ = moe.route(x)
    port_i = torch.empty(100, dtype=torch.int64)
    port_i[sorted_pairs] = torch.repeat_interleave(torch.arange(8), torch.diff(offsets, prepend=offsets.new_zeros(1)))
    order = torch.argsort(port_i.view(50, 2), dim=-1)
    assert torch.equal(port_i.view(50, 2).gather(1, order), want_i)
    torch.testing.assert_close(weights.gather(1, order), want_w, rtol=1e-6, atol=1e-7)


def _scan_inputs(b, t, h=3, d=16, seed=7, strength=1.0):
    g = torch.Generator().manual_seed(seed)
    q, k = (_l2(torch.randn(b, t, h, d, generator=g)) for _ in range(2))
    v = torch.randn(b, t, h, d, generator=g)
    a = 1 + 15 * torch.rand(h, generator=g)
    decay = -strength * a.view(h, 1) * F.softplus(0.3 * torch.randn(b, t, h, d, generator=g) - 3)
    return q, k, v, decay, torch.rand(b, t, h, generator=g)


@pytest.mark.parametrize("t", [1, 63, 64, 65, 200])
@pytest.mark.parametrize("strength", [1.0, 10.0], ids=["seeded", "ten_times"])
def test_chunked_scan_matches_token_recurrence(t, strength):
    """At lengths that are not whole chunks, at the seeded decays (A_log in
    [0, log 16], dt in [0.001, 0.1]) and at decays ten times stronger: within
    2e-6 of the token recurrence, nothing infinite."""
    q, k, v, decay, beta = _scan_inputs(2, t, strength=strength)
    got = kda.kda_scan(q, k, v, decay, beta)
    assert got.shape == (2, t, 3, 16) and torch.isfinite(got).all()
    torch.testing.assert_close(got, ref.kda_recurrence(q, k, v, decay, beta), rtol=0, atol=2e-6)


def test_chunked_scan_under_extreme_decays_has_no_inf_or_nan():
    """Decays of e^-1000 a token in some channels (a state wiped at once) and
    none in others: finite, and within 2e-6 of the token recurrence."""
    q, k, v, decay, beta = _scan_inputs(1, 130)
    decay[..., ::3] = -1000.0
    decay[..., 1::3] = 0.0
    got = kda.kda_scan(q, k, v, decay, beta)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref.kda_recurrence(q, k, v, decay, beta), rtol=0, atol=2e-6)


def test_chunked_scan_with_right_padding():
    """Rows padded on the right: each row's real outputs equal its own
    unpadded recurrence, whatever the pads hold."""
    q, k, v, decay, beta = _scan_inputs(3, 150)
    got = kda.kda_scan(q, k, v, decay, beta)
    for r, n in enumerate((150, 70, 129)):
        want = ref.kda_recurrence(q[r : r + 1, :n], k[r : r + 1, :n], v[r : r + 1, :n], decay[r : r + 1, :n],
                                  beta[r : r + 1, :n])
        torch.testing.assert_close(got[r : r + 1, :n], want, rtol=0, atol=2e-6)


def _k6_tiles(n=2, bh=3, d=kda.K6_HEAD_DIM):
    """Chunk tiles of the shapes K6 takes: q, k, v, g (n, bh, d, CHUNK) and
    beta (n, bh, 1, CHUNK), f32 and contiguous."""
    g = torch.Generator().manual_seed(5)
    q, k = (F.normalize(torch.randn(n, bh, d, kda.CHUNK, generator=g), dim=2) for _ in range(2))
    v = torch.randn(n, bh, d, kda.CHUNK, generator=g)
    return [q, k, v, -torch.rand(n, bh, d, kda.CHUNK, generator=g), torch.rand(n, bh, 1, kda.CHUNK, generator=g)]


def test_scan_chunks_runs_the_plain_version_on_cpu(monkeypatch):
    """On CPU tensors ``scan_chunks`` is ``scan_chunks_reference``: the same
    outputs, no kernel library loaded and no launch counted."""
    from lotus_tpu_torch.ops import _kernels

    calls = []
    plain = kda.scan_chunks_reference
    monkeypatch.setattr(kda, "scan_chunks_reference", lambda *args: calls.append(1) or plain(*args))
    monkeypatch.setattr(_kernels, "lib", None)  # any load of the library would raise
    launches = kda.scan_chunks.launches
    tiles = _k6_tiles()
    got = kda.scan_chunks(*tiles)
    assert calls == [1] and kda.scan_chunks.launches == launches
    assert torch.equal(got, plain(*tiles))


def _k6_bad(case):
    q, k, v, g, beta = _k6_tiles()
    if case == "f64":
        q = q.double()
    elif case == "bf16_beta":
        beta = beta.bfloat16()
    elif case == "head_dim_64":
        q, k, v, g, beta = _k6_tiles(d=64)
    elif case == "value_dim_64":
        v = v[:, :, :64].contiguous()
    elif case == "chunk_32":
        q, k, v, g = (x[..., :32].contiguous() for x in (q, k, v, g))
        beta = beta[..., :32].contiguous()
    elif case == "transposed":
        v = v.mT.contiguous().mT
    elif case == "misaligned":
        k = torch.empty(k.numel() + 1)[1:].view_as(k).copy_(k)
    elif case == "three_dims":
        q, k, v, g, beta = (x[0] for x in (q, k, v, g, beta))
    return q, k, v, g, beta


@pytest.mark.parametrize("case", ["f64", "bf16_beta", "head_dim_64", "value_dim_64", "chunk_32", "transposed",
                                  "misaligned", "three_dims"])
def test_k6_argument_checks_refuse_what_it_does_not_take(case):
    """K6's checks (run on the card before the library is loaded or a kernel
    launched) refuse another type, head size, chunk, layout or alignment
    with a clear message, and pass the shapes the published config gives."""
    assert kda.check_k6_args(*_k6_tiles()) == (2, 3)
    with pytest.raises(ValueError, match="scan_chunks"):
        kda.check_k6_args(*_k6_bad(case))


def _moe_layer(held=None):
    weights = ref.layer_weights(CFG, SEED, 1, CPU, torch.float32)
    cfg = kimi.KimiLinearConfig.from_dict(CFG)
    with torch.device("meta"):
        moe = dsv2.DeepseekV2MoE(cfg, 1, held)
    state = {k.removeprefix("mlp."): v.clone() for k, v in weights.items() if k.startswith("mlp.")}
    missing, _ = moe.load_state_dict(state, strict=False, assign=True)
    assert not missing
    return moe.eval(), weights


def test_moe_layer_matches_reference():
    moe, weights = _moe_layer()
    x = torch.randn(2, 37, CFG["hidden_size"], generator=torch.Generator().manual_seed(3))
    expected = ref.PlainKimiLinear(CFG, SEED, CPU).moe(x.reshape(-1, CFG["hidden_size"]), weights)
    with torch.no_grad():
        torch.testing.assert_close(moe(x).reshape(-1, CFG["hidden_size"]), expected, rtol=1e-5, atol=1e-6)


def test_four_expert_shares_add_up_to_the_whole_layer():
    """Four shares of two experts each, each routing over all 8 with the
    sigmoid router and computing its own experts' part, add up to the uncut
    layer with the shared expert counted once."""
    whole, _ = _moe_layer()
    shares = [_moe_layer((e, e + 2))[0] for e in range(0, 8, 2)]
    x = torch.randn(3, 20, CFG["hidden_size"], generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        shared = whole.shared_experts(x)
        parts = sum(s(x) for s in shares) - 3 * shared
        torch.testing.assert_close(parts, whole(x), rtol=1e-5, atol=1e-6)


# DeepSeek-V2's latent attention and softmax route as they were before the
# NoPE and sigmoid paths were added, kept here to hold the shared code to them.
def _rope_attention_before(self, x, bias, cos, sin):
    b, s, _ = x.shape
    h = self.heads
    q_nope, q_pe = self.q_proj(x).view(b, s, h, -1).transpose(1, 2).split([self.nope, self.rope], dim=-1)
    latent, k_pe = self.kv_a_proj_with_mqa(x).split([self.rank, self.rope], dim=-1)
    kv = self.kv_b_proj(self.kv_a_layernorm(latent)).view(b, s, h, -1).transpose(1, 2)
    k_nope, v = kv.split([self.nope, self.v_dim], dim=-1)
    q = torch.cat((q_nope, dsv2.rotate_pairs(q_pe, cos, sin)), dim=-1)
    k_pe = dsv2.rotate_pairs(k_pe[:, None], cos, sin).expand(b, h, s, self.rope)
    k = torch.cat((k_nope, k_pe), dim=-1)
    ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=self.scale)
    return self.o_proj(ctx.transpose(1, 2).reshape(b, s, h * self.v_dim))


def _softmax_route_before(self, x):
    logits = F.linear(x.float(), self.gate.weight.float())
    weights, idx = torch.topk(logits.softmax(dim=-1), self.top_k, dim=-1)
    if self.norm_topk:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    weights = weights * self.scaling
    n = self.held[1] - self.held[0]
    local = idx.reshape(-1) - self.held[0]
    held = (local >= 0) & (local < n)
    group = torch.where(held, local, n)
    order = torch.argsort(group, stable=True)
    counts = torch.zeros(n + 1, dtype=torch.int32, device=x.device)
    counts.scatter_add_(0, group, torch.ones_like(group, dtype=torch.int32))
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(order.numel(), device=x.device))
    return weights, order, torch.cumsum(counts[:n], 0, dtype=torch.int32), inv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_deepseek_v2_path_unchanged_bit_for_bit(dtype, monkeypatch):
    """DeepSeek-V2's rope latent attention and softmax route give the same
    bits as before the shared code gained Kimi-Linear's paths."""
    from test_torch_deepseek_v2 import CFG as DSV2, batch as dsv2_batch

    weights = {"model." + k: v for k, v in ref_dsv2.model_weights(DSV2, SEED, CPU, dtype).items()}
    with torch.device("meta"):
        model = dsv2.DeepseekV2Model(dsv2.DeepseekV2Config.from_dict(DSV2))
    model = fit_state_dict(model, weights).eval()
    ids, mask = dsv2_batch()
    with torch.no_grad():
        now = model(ids, mask)
        monkeypatch.setattr(dsv2.DeepseekV2Attention, "forward", _rope_attention_before)
        monkeypatch.setattr(dsv2.DeepseekV2MoE, "route", _softmax_route_before)
        before = model(ids, mask)
    assert torch.equal(now, before)


def _scan_with(monkeypatch, change):
    """``change(q, k, v, g, beta)`` applied to the recurrence's chunk tiles."""
    scan = kda.scan_chunks
    monkeypatch.setattr(kda, "scan_chunks", lambda *args: scan(*change(*args)))


def _no_decay(monkeypatch):
    _scan_with(monkeypatch, lambda q, k, v, g, beta: (q, k, v, torch.zeros_like(g), beta))


def _no_beta(monkeypatch):
    _scan_with(monkeypatch, lambda q, k, v, g, beta: (q, k, v, g, torch.ones_like(beta)))


def state_reset_each_chunk(monkeypatch):
    """The recurrence run on each 64-token chunk alone, from a zero state."""
    scan = kda.scan_chunks

    def reset(*args):
        return torch.cat([scan(*(x[i : i + 1] for x in args)) for i in range(args[0].shape[0])])

    monkeypatch.setattr(kda, "scan_chunks", reset)


def _conv_one_ahead(monkeypatch):
    conv = kimi.causal_conv
    monkeypatch.setattr(kimi, "causal_conv", lambda y, weight: F.pad(conv(y, weight)[..., 1:], (0, 1)))


def _no_correction_bias(monkeypatch):
    route = dsv2.DeepseekV2MoE.route

    def without(self, x):
        self.gate.e_score_correction_bias.data.zero_()
        return route(self, x)

    monkeypatch.setattr(dsv2.DeepseekV2MoE, "route", without)


FAULTS = {"decay_dropped": _no_decay, "beta_dropped": _no_beta, "state_reset_each_chunk": state_reset_each_chunk,
          "conv_sees_one_ahead": _conv_one_ahead, "correction_bias_dropped": _no_correction_bias}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails_the_comparison(fault, monkeypatch, plain_f32):
    """Each fault, planted in the port, fails the f32 comparison (1e-5) by at
    least 10 times."""
    FAULTS[fault](monkeypatch)
    assert worst_rel(port(), plain_f32) > 1e-4


def write_checkpoint(path: Path, seed: int = SEED) -> dict:
    """A ``KimiLinearForCausalLM`` directory: ``config.json``, the weights
    under the published names (``model.``, ``lm_head``; ``A_log`` as (1, 1,
    heads, 1)) in ``model.safetensors``, and the seeded byte-level BPE
    tokenizer."""
    weights = {"model." + k: v for k, v in ref.model_weights(CFG, seed, CPU, torch.float32).items()}
    for name in [n for n in weights if n.endswith("A_log")]:
        weights[name] = weights[name].view(1, 1, -1, 1).contiguous()
    weights["lm_head.weight"] = torch.randn(CFG["vocab_size"], CFG["hidden_size"])
    words = [w for w in texts.make_vocab(seed, 2000) if w.isalpha()]
    spec = bpe_files.bpe_spec(words, CFG["vocab_size"])
    bpe_files.write_tokenizer_dir(str(path), spec, {**CFG, "architectures": ["KimiLinearForCausalLM"]})
    texts.write_safetensors(str(path / "model.safetensors"), weights)
    return spec


def test_families_load_a_checkpoint_and_the_rm_embeds_from_it(tmp_path):
    """``kimi_linear`` in ``checkpoint.FAMILIES``: the RM reads the
    checkpoint (``lm_head`` dropped, ``A_log`` reshaped) and embeds as the
    reference does, fed the plain BPE encoder's ids; so does the RM over the
    encoder built and handed over."""
    assert FAMILIES["kimi_linear"][:2] == (kimi.KimiLinearConfig, kimi.KimiLinearModel)
    spec = write_checkpoint(tmp_path)
    docs = ["Alpha beta gamma.", "A much longer text, of several words; with punctuation too.", "x"]
    from_dir = TorchSentenceEncoderRM(model=str(tmp_path), max_batch_size=2, max_seq_length=32, device="cpu")
    built = TorchSentenceEncoderRM(model=str(tmp_path), max_batch_size=2, max_seq_length=32, device="cpu",
                                   encoder=port())
    assert isinstance(from_dir.encoder, kimi.KimiLinearModel) and not hasattr(from_dir.encoder, "lm_head")
    bpe = ByteBPE(spec, bpe_files.BOS)
    expected = ref.PlainKimiLinear(CFG, SEED, CPU, torch.float32).embed([bpe.encode(d, 32) for d in docs])
    for rm in (from_dir, built):
        np.testing.assert_allclose(rm(docs), expected, atol=2e-6)


def test_config_refuses_what_the_port_does_not_run():
    with pytest.raises(ValueError, match="kda_layers"):
        kimi.KimiLinearConfig.from_dict({**CFG, "linear_attn_config": {**CFG["linear_attn_config"],
                                                                       "kda_layers": [1, 2]}})
    with pytest.raises(NotImplementedError, match="mla_use_nope"):
        kimi.KimiLinearConfig.from_dict({**CFG, "mla_use_nope": False})
    with pytest.raises(NotImplementedError, match="one group"):
        kimi.KimiLinearConfig.from_dict({**CFG, "num_expert_group": 2})
    cfg = kimi.KimiLinearConfig.from_dict(CFG)
    assert (cfg.n_routed_experts, cfg.num_experts_per_tok, cfg.n_shared_experts) == (8, 2, 1)
    assert (cfg.topk_method, cfg.scoring_func, cfg.norm_topk_prob) == ("noaux_tc", "sigmoid", True)
    assert [i for i in range(4) if cfg.is_kda(i)] == [0, 1, 2]


SPANS = {"rm.call", "rm.tokenize", "rm.forward", "kda.attn", "kda.scan", "mla.attn", "moe.route", "moe.experts",
         "moe.shared", "moe.combine"}


def test_spans_and_counters_cost_one_flag_check(tmp_path, monkeypatch):
    """With no profiler running each span site and each KDA and MoE layer's
    counter check the profiler's flag once and record nothing; under a
    profiler the spans are recorded and ``kda.tokens`` holds every (token,
    head) pair each KDA layer's scan ran over, padding included."""
    write_checkpoint(tmp_path)
    rm = TorchSentenceEncoderRM(model=str(tmp_path), max_batch_size=2, max_seq_length=32, device="cpu")
    docs = ["Alpha beta gamma.", "Delta epsilon.", "Zeta eta theta iota."]
    checks = []
    flag = profiling._profiler_enabled
    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: checks.append(1) or flag())
    monkeypatch.setattr(profiling, "_Span", None)  # any span object made would raise
    monkeypatch.setattr(profiling, "tally", None)
    rm(docs)
    batches = 2
    per_forward = 1 + CFG["num_hidden_layers"] + 2 * KDA_LAYERS + 4 * MOE_LAYERS + MOE_LAYERS
    assert len(checks) == 1 + (batches + 1) + batches * per_forward
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]):
        rm(docs)
    totals = profiling.span_totals()
    assert SPANS <= set(totals) and totals["rm.forward"].calls == batches
    assert totals["kda.attn"].calls == totals["kda.scan"].calls == batches * KDA_LAYERS
    assert totals["mla.attn"].calls == batches
    assert {r["attrs"]["route"] for r in profiling.span_records() if r["name"] == "kda.scan"} == {"plain"}
    tokens = profiling.counter_totals()["kda.tokens"]
    padded = sum(ids.numel() for _, ids, _ in _batches(rm, docs))
    heads = CFG["linear_attn_config"]["num_heads"]
    assert tokens.shape == (CFG["num_hidden_layers"], 1)
    assert tokens[:, 0].tolist() == [padded * heads] * KDA_LAYERS + [0]


def _batches(rm, docs):
    from lotus_tpu_torch.models.torch_rm import bucketed_batches

    return list(bucketed_batches(rm.tokenizer, docs, None, rm.max_batch_size, rm.max_seq_length, rm.device))
