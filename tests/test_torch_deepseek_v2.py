"""DeepSeek-V2 (``lotus_tpu_torch/models/deepseek_v2.py``) on the CPU, at a
small config with seeded weights (3 layers of which 1 dense; 8 experts, top
2, 2 shared; latent 32, rope 16, nope 32, v 32; YaRN factor 40): against the
benchmark's plain reference (``perfbench/reference/deepseek_v2.py``) in f32
and bf16, the reference against ``transformers``' ``DeepseekV2Model``, the
checkpoint loader, the grouped dispatch, planted faults, and the cost of its
spans and counters with no profiler running."""

import json
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from perfbench import bpe_files, texts  # noqa: E402
from perfbench.reference import deepseek_v2 as ref  # noqa: E402
from perfbench.reference.bpe import ByteBPE  # noqa: E402

from lotus_tpu_torch import profiling  # noqa: E402
from lotus_tpu_torch.models import TorchSentenceEncoderRM  # noqa: E402
from lotus_tpu_torch.models import deepseek_v2 as dsv2  # noqa: E402
from lotus_tpu_torch.models.checkpoint import fit_state_dict  # noqa: E402

CFG = dict(model_type="deepseek_v2", vocab_size=320, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
           num_hidden_layers=3, num_attention_heads=4, n_shared_experts=2, n_routed_experts=8, num_experts_per_tok=2,
           first_k_dense_replace=1, moe_layer_freq=1, norm_topk_prob=False, routed_scaling_factor=1.0,
           q_lora_rank=None, kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
           max_position_embeddings=163840, rope_theta=10000, rms_norm_eps=1e-6, topk_method="greedy",
           scoring_func="softmax", hidden_act="silu", attention_bias=False,
           rope_scaling={"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707, "mscale_all_dim": 0.707,
                         "original_max_position_embeddings": 4096, "type": "yarn"})
SEED = 2**31 + 77
LENS = [60, 33, 48]  # right-padded to 64 in one batch
CPU = torch.device("cpu")


def port(dtype=torch.float32, cfg=CFG, seed=SEED, **kw):
    """The port's model with the reference's seeded weights, loaded under the
    checkpoint's names."""
    weights = ref.model_weights(cfg, seed, CPU, dtype)
    with torch.device("meta"):
        model = dsv2.DeepseekV2Model(dsv2.DeepseekV2Config.from_dict(cfg), **kw)
    return fit_state_dict(model, {"model." + k: v.clone() for k, v in weights.items()}).eval()


def batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, CFG["vocab_size"], (len(LENS), 64), generator=g)
    mask = torch.zeros(len(LENS), 64, dtype=torch.int64)
    for r, n in enumerate(LENS):
        mask[r, :n] = 1
    return ids, mask


def reference_hidden(dtype=torch.float32, cfg=CFG, seed=SEED):
    ids, _ = batch()
    return ref.PlainDeepseekV2(cfg, seed, CPU, dtype).hidden([ids[r, :n].tolist() for r, n in enumerate(LENS)])


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
    """bf16 keeps 8 bits of mantissa (2^-9 relative a rounding) and a layer
    rounds each product's inputs and output a dozen times: over seeds the
    three layers read at most 0.009 of the largest value, at published
    widths over two layers 0.020; 0.03 leaves room at this size, and an f32
    slip (a lost mscale, a wrong expert) reads 10 times more."""
    plain = reference_hidden(torch.bfloat16)
    assert worst_rel(port(torch.bfloat16), plain) <= 0.03


def test_reference_matches_transformers(plain_f32):
    """``transformers``' ``DeepseekV2Model`` with its attention scale times
    mscale(40, 0.707)^2, the one departure of its native port from the
    published remote code, which the reference follows."""
    transformers = pytest.importorskip("transformers")
    if not hasattr(transformers, "DeepseekV2Model"):
        pytest.skip("this transformers has no DeepseekV2Model")
    hf_cfg = transformers.DeepseekV2Config(**{k: v for k, v in CFG.items() if k != "model_type"})
    hf_cfg._attn_implementation = "eager"
    hf = transformers.DeepseekV2Model(hf_cfg).eval()
    missing, unexpected = hf.load_state_dict(ref.model_weights(CFG, SEED, CPU, torch.float32), strict=False)
    assert not missing and not unexpected
    for layer in hf.layers:
        layer.self_attn.scaling *= ref.yarn_get_mscale(40, 0.707) ** 2
    ids, _ = batch()
    with torch.no_grad():
        for r, n in enumerate(LENS):
            got = hf(input_ids=ids[r : r + 1, :n]).last_hidden_state[0]
            assert float((got - plain_f32[r]).abs().max() / plain_f32[r].abs().max()) <= 1e-5


def write_checkpoint(path: Path, seed: int = SEED) -> dict:
    """A ``DeepseekV2ForCausalLM`` directory: ``config.json``, the weights
    under Hugging Face's names (``model.`` and ``lm_head``) in
    ``model.safetensors``, and the seeded byte-level BPE tokenizer."""
    weights = {"model." + k: v for k, v in ref.model_weights(CFG, seed, CPU, torch.float32).items()}
    weights["lm_head.weight"] = torch.randn(CFG["vocab_size"], CFG["hidden_size"])
    words = [w for w in texts.make_vocab(seed, 2000) if w.isalpha()]
    spec = bpe_files.bpe_spec(words, CFG["vocab_size"])
    bpe_files.write_tokenizer_dir(str(path), spec, {**CFG, "architectures": ["DeepseekV2ForCausalLM"]})
    texts.write_safetensors(str(path / "model.safetensors"), weights)
    return spec


def test_rm_embeds_from_a_checkpoint_and_from_a_built_encoder(tmp_path):
    """The RM's normal path, whichever way the encoder came: read from a
    safetensors checkpoint under Hugging Face's names (``lm_head`` dropped), or
    built on the device and handed over; both against the reference fed the
    plain BPE encoder's ids."""
    spec = write_checkpoint(tmp_path)
    docs = ["Alpha beta gamma.", "A much longer text, of several words; with punctuation too.", "x"]
    from_dir = TorchSentenceEncoderRM(model=str(tmp_path), max_batch_size=2, max_seq_length=32, device="cpu")
    built = TorchSentenceEncoderRM(model=str(tmp_path), max_batch_size=2, max_seq_length=32, device="cpu",
                                   encoder=port())
    assert not hasattr(from_dir.encoder, "lm_head")
    bpe = ByteBPE(spec, bpe_files.BOS)
    assert [from_dir.tokenizer.encode([d], max_length=32)[0] for d in docs] == [bpe.encode(d, 32) for d in docs]
    expected = ref.PlainDeepseekV2(CFG, SEED, CPU, torch.float32).embed([bpe.encode(d, 32) for d in docs])
    for rm in (from_dir, built):
        np.testing.assert_allclose(rm(docs), expected, atol=2e-6)


def _moe_layer(held=None, silent=(5, 6, 7)):
    """Layer 1 of the port (MoE) with the gate rows of ``silent`` experts
    pushed far down, so that they get no tokens of positive inputs."""
    weights = ref.layer_weights(CFG, SEED, 1, CPU, torch.float32)
    for e in silent:
        weights["mlp.gate.weight"][e] -= 50.0
    cfg = dsv2.DeepseekV2Config.from_dict(CFG)
    with torch.device("meta"):
        moe = dsv2.DeepseekV2MoE(cfg, 1, held)
    state = {k.removeprefix("mlp."): v.clone() for k, v in weights.items() if k.startswith("mlp.")}
    missing, _ = moe.load_state_dict(state, strict=False, assign=True)
    assert not missing
    return moe.eval(), weights


def test_grouped_dispatch_matches_the_loop_with_empty_experts():
    moe, weights = _moe_layer()
    x = torch.rand(2, 37, CFG["hidden_size"], generator=torch.Generator().manual_seed(3)) + 0.1
    _, order, offsets, _ = moe.route(x.reshape(-1, CFG["hidden_size"]))
    sizes = torch.diff(offsets, prepend=offsets.new_zeros(1))
    assert (sizes[[5, 6, 7]] == 0).all() and (sizes[:5] > 0).all()
    expected = ref.PlainDeepseekV2(CFG, SEED, CPU, torch.float32).moe(x.reshape(-1, CFG["hidden_size"]), weights)
    with torch.no_grad():
        got = moe(x).reshape(-1, CFG["hidden_size"])
    torch.testing.assert_close(got, expected, rtol=1e-5, atol=1e-6)


def test_expert_shares_add_up_to_the_whole_layer():
    """Two halves of the experts, each layer routing over all 8 and computing
    its own experts' part, add up to the whole layer with the shared experts
    counted once."""
    whole, _ = _moe_layer(silent=())
    lo, _ = _moe_layer((0, 4), silent=())
    hi, _ = _moe_layer((4, 8), silent=())
    x = torch.randn(3, 20, CFG["hidden_size"], generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        shared = whole.shared_experts(x)
        parts = lo(x) + hi(x) - shared
        torch.testing.assert_close(parts, whole(x), rtol=1e-5, atol=1e-6)


def _scale_without_mscale(monkeypatch):
    monkeypatch.setattr(dsv2.DeepseekV2Config, "softmax_scale",
                        property(lambda c: (c.qk_nope_head_dim + c.qk_rope_head_dim) ** -0.5))


def _plain_frequencies(monkeypatch):
    table = dsv2.rope_table
    monkeypatch.setattr(dsv2, "rope_table", lambda cfg, s, dev: table(replace(cfg, rope_scaling=None), s, dev))


def _moe_modules(model):
    return [m for m in model.modules() if isinstance(m, dsv2.DeepseekV2MoE)]


FAULTS = {
    "scale_without_mscale": (_scale_without_mscale, None),
    "plain_rope_frequencies": (_plain_frequencies, None),
    "one_expert_fewer": (None, lambda moe: setattr(moe, "top_k", moe.top_k - 1)),
    "renormalised_weights": (None, lambda moe: setattr(moe, "norm_topk", True)),
    "shared_experts_skipped": (None, lambda moe: delattr(moe, "shared_experts")),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails_the_comparison(fault, monkeypatch, plain_f32):
    """Each fault, planted in the port, fails the f32 comparison (1e-5) by at
    least 10 times (top-1 of 2 here stands for top-5 of 6; YaRN's frequencies
    differ from the plain ones in the slow pairs only, so that fault reads
    the least, about 7e-4 over 64 positions)."""
    before, on_moe = FAULTS[fault]
    if before:
        before(monkeypatch)
    model = port()
    if on_moe:
        for moe in _moe_modules(model):
            on_moe(moe)
    assert worst_rel(model, plain_f32) > 1e-4


SPANS = {"rm.call", "rm.tokenize", "rm.forward", "mla.attn", "moe.route", "moe.experts", "moe.shared"}


def test_spans_and_counters_cost_one_flag_check(tmp_path, monkeypatch):
    """With no profiler running each span site and each MoE layer's counter
    check the profiler's flag once and record nothing; under a profiler the
    RM's and the model's spans are recorded and the counters hold every
    routed pair."""
    write_checkpoint(tmp_path)
    rm = TorchSentenceEncoderRM(model=str(tmp_path), max_batch_size=2, max_seq_length=32, device="cpu")
    docs = ["Alpha beta gamma.", "Delta epsilon.", "Zeta eta theta iota."]
    checks = []
    flag = profiling._profiler_enabled
    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: checks.append(1) or flag())
    monkeypatch.setattr(profiling, "_Span", None)  # any span object made would raise
    monkeypatch.setattr(profiling, "tally", None)
    rm(docs)
    batches, moe_layers = 2, 2
    sites = 1 + (batches + 1) + batches * (1 + CFG["num_hidden_layers"] + 3 * moe_layers)
    assert len(checks) == sites + batches * moe_layers
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]):
        rm(docs)
    totals = profiling.span_totals()
    assert SPANS <= set(totals) and totals["rm.call"].roots == 1 and totals["rm.forward"].calls == batches
    assert totals["mla.attn"].calls == batches * CFG["num_hidden_layers"]
    counters = profiling.counter_totals()
    pairs = counters["moe.pairs"]
    assert pairs.shape == (CFG["num_hidden_layers"], CFG["n_routed_experts"]) and int(pairs[0].sum()) == 0
    padded = sum(ids.numel() for _, ids, _ in _batches(rm, docs))
    assert (pairs[1:].sum(dim=1) == padded * CFG["num_experts_per_tok"]).all()
    assert (counters["moe.pairs_max"][1:, 0] >= pairs[1:].sum(dim=1) / CFG["n_routed_experts"]).all()
    assert (counters["moe.experts_used"][1:, 0] <= batches * CFG["n_routed_experts"]).all()


def _batches(rm, docs):
    from lotus_tpu_torch.models.torch_rm import bucketed_batches

    return list(bucketed_batches(rm.tokenizer, docs, None, rm.max_batch_size, rm.max_seq_length, rm.device))


def test_config_refuses_what_the_port_does_not_run():
    with pytest.raises(NotImplementedError, match="topk_method"):
        dsv2.DeepseekV2Config.from_dict({**CFG, "topk_method": "group_limited_greedy"})
    with pytest.raises(NotImplementedError, match="rope_scaling"):
        dsv2.DeepseekV2Config.from_dict({**CFG, "rope_scaling": {"type": "dynamic", "factor": 2.0}})
    cfg = dsv2.DeepseekV2Config.from_dict(json.loads(json.dumps(CFG)))
    assert abs(cfg.softmax_scale * 48**0.5 - (0.1 * 0.707 * np.log(40) + 1) ** 2) < 1e-12
