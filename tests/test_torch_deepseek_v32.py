"""DeepSeek-V3.2-Exp (``lotus_tpu_torch/models/deepseek_v32.py``) and its
sparse attention (``lotus_tpu_torch/ops/dsa.py``) on the CPU, at a small
config with seeded weights (1 dense and 2 MoE layers; hidden 64, 4 heads, a
query LoRA of 32, latent 16; an indexer of 16 heads of 32 keeping 16 keys a
query at 64-96 tokens, so that the selection bites; 16 sigmoid-routed
experts in 4 groups, 2 groups kept, top 4, 1 shared): against the
benchmark's plain reference (``perfbench/reference/deepseek_v32.py``) in
f32 and bf16, dense causal latent attention where the selection covers the
sequence, right padding, the group-limited router and the query-LoRA
attention against ``transformers``' DeepSeek-V3, the indexer's blocks and the
absorbed attention against their formulas, the expert shares, DeepSeek-V2's
and Kimi-Linear's paths unchanged, planted faults, the checkpoint loader,
the config's refusals, and the cost of the spans and counters with no
profiler running."""

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
from perfbench.reference import deepseek_v32 as ref  # noqa: E402
from perfbench.reference import kimi_linear as ref_kimi  # noqa: E402
from perfbench.reference.bpe import ByteBPE  # noqa: E402

from lotus_tpu_torch import profiling  # noqa: E402
from lotus_tpu_torch.models import TorchSentenceEncoderRM  # noqa: E402
from lotus_tpu_torch.models import deepseek_v2 as dsv2  # noqa: E402
from lotus_tpu_torch.models import deepseek_v32 as v32  # noqa: E402
from lotus_tpu_torch.models import kimi_linear as kimi  # noqa: E402
from lotus_tpu_torch.models.checkpoint import FAMILIES, fit_state_dict  # noqa: E402
from lotus_tpu_torch.ops import dsa  # noqa: E402

CFG = dict(model_type="deepseek_v32", vocab_size=320, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
           num_hidden_layers=3, num_attention_heads=4, n_shared_experts=1, n_routed_experts=16, num_experts_per_tok=4,
           n_group=4, topk_group=2, first_k_dense_replace=1, moe_layer_freq=1, norm_topk_prob=True,
           routed_scaling_factor=2.5, topk_method="noaux_tc", scoring_func="sigmoid", q_lora_rank=32, kv_lora_rank=16,
           qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32, index_n_heads=16, index_head_dim=32,
           index_topk=16, max_position_embeddings=163840, rope_theta=10000, rms_norm_eps=1e-6, hidden_act="silu",
           attention_bias=False, tie_word_embeddings=False, num_nextn_predict_layers=1,
           rope_scaling={"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 1.0, "mscale_all_dim": 1.0,
                         "original_max_position_embeddings": 4096, "type": "yarn"})
SEED = 2**31 + 2626
LENS = [96, 70, 81]  # right-padded to 96 in one batch
CPU = torch.device("cpu")
MOE_LAYERS = 2


def port(dtype=torch.float32, cfg=CFG, seed=SEED, **kw):
    """The port's model with the reference's seeded weights, loaded under the
    checkpoint's names."""
    weights = ref.model_weights(cfg, seed, CPU, dtype)
    with torch.device("meta"):
        model = v32.DeepseekV32Model(v32.DeepseekV32Config.from_dict(cfg), **kw)
    return fit_state_dict(model, {"model." + k: v.clone() for k, v in weights.items()}).eval()


def batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, CFG["vocab_size"], (len(LENS), max(LENS)), generator=g)
    mask = (torch.arange(max(LENS))[None] < torch.tensor(LENS)[:, None]).long()
    return ids, mask


def reference_hidden(dtype=torch.float32, cfg=CFG, seed=SEED):
    ids, _ = batch()
    return ref.PlainDeepseekV32(cfg, seed, CPU, dtype).hidden([ids[r, :n].tolist() for r, n in enumerate(LENS)])


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
    """bf16 rounds each projection's inputs and outputs.  That moves index
    scores within a rounding of a query's 16th best past each other, and a
    swapped key is a 16th of that token's attention, so the widest token
    gap is large where the typical one is small: over five seeds the
    median over a text's tokens of the relative L2 gap reads 0.0051-0.0079
    (limit 0.015) and the widest gap 0.084-0.156 of the text's largest value
    (limit 0.3)."""
    plain = reference_hidden(torch.bfloat16)
    ids, mask = batch()
    with torch.no_grad():
        out = port(torch.bfloat16)(ids, mask).float()
    for r, (n, p) in enumerate(zip(LENS, plain)):
        assert float(((out[r, :n] - p).norm(dim=-1) / p.norm(dim=-1)).median()) <= 0.015
        assert float((out[r, :n] - p).abs().max() / p.abs().max()) <= 0.3


def _dense_attention(self, x, cos, sin):
    return dsv2.DeepseekV2Attention.forward(self, x, None, cos, sin)


def test_selection_covering_the_sequence_is_dense_causal_attention(monkeypatch):
    """With ``index_topk`` at least the sequence every query keeps all its
    earlier keys, and the sparse path equals dense causal latent attention
    (SDPA over the same projections) within f32 rounding."""
    cfg = {**CFG, "index_topk": max(LENS)}
    model = port(cfg=cfg)
    ids, mask = batch()
    with torch.no_grad():
        sparse = model(ids, mask)
        monkeypatch.setattr(v32.DeepseekV32Attention, "forward", _dense_attention)
        dense = model(ids, mask)
    for r, n in enumerate(LENS):
        assert float((sparse[r, :n] - dense[r, :n]).abs().max() / dense[r, :n].abs().max()) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_right_padding_leaves_the_real_rows_as_they_are_alone(dtype):
    """Each right-padded row's real outputs equal the row's own forward at
    its own length (f32 rounding; in bf16 the rare index score within a
    rounding of the 16th best may change places: 0.02 of the row's largest
    value)."""
    model = port(dtype)
    ids, mask = batch()
    with torch.no_grad():
        padded = model(ids, mask).float()
        for r, n in enumerate(LENS):
            alone = model(ids[r : r + 1, :n], mask[r : r + 1, :n])[0].float()
            gap = float((padded[r, :n] - alone).abs().max() / alone.abs().max())
            assert gap <= (1e-5 if dtype == torch.float32 else 0.02)


def _index_inputs(b=2, s=70, heads=16, d=8, seed=3):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, s, heads, d, generator=g), torch.randn(b, s, d, generator=g),
            torch.randn(b, s, heads, generator=g))


@pytest.mark.parametrize("cells", [1 << 29, 16 * 70 * 8, 16 * 70], ids=["one_block", "blocks_of_8", "one_query"])
def test_index_topk_is_the_causal_top_k_in_any_blocks(cells, monkeypatch):
    """In one block of queries or in many (down to one query a block), each
    row's selection is the top ``min(16, t + 1)`` earlier keys by
    sum_h w ReLU(q . k), and a short row's tail holds only later keys."""
    monkeypatch.setattr(dsa, "INDEX_BLOCK_CELLS", cells)
    q, k, w = _index_inputs()
    got = dsa.index_topk(q, k, w, 16)
    assert got.shape == (2, 70, 16)
    scores = torch.einsum("bthd,bud->bthu", q, k).relu().mul(w[..., None]).sum(2)
    for r in range(2):
        for t in range(70):
            want = set(torch.topk(scores[r, t, : t + 1], min(16, t + 1)).indices.tolist())
            row = got[r, t].tolist()
            assert {u for u in row if u <= t} == want and all(u > t for u in row if u not in want)


@pytest.mark.parametrize("pairs", [1 << 19, 8 * 16], ids=["one_block", "blocks_of_8"])
def test_absorbed_attention_equals_the_non_absorbed_formula(pairs, monkeypatch):
    """Attention in the absorbed form over a selection equals the
    published non-absorbed formula (keys and values up-projected per head,
    scores masked to the selection and to earlier keys, softmax, values)
    within f32 rounding, in one block or in many."""
    monkeypatch.setattr(dsa, "ATTN_BLOCK_PAIRS", pairs)
    g = torch.Generator().manual_seed(9)
    b, s, h, nope, rope, rank, v = 2, 40, 3, 8, 4, 6, 5
    q_nope, q_pe = torch.randn(b, s, h, nope, generator=g), torch.randn(b, s, h, rope, generator=g)
    kv = torch.randn(b, s, rank + rope, generator=g)
    up = torch.randn(h, nope + v, rank, generator=g)
    q, k, w = _index_inputs(b, s, seed=4)
    idx = dsa.index_topk(q, k, w, 16)
    got = dsa.sparse_attention(q_nope, q_pe, kv, idx, up[:, :nope], up[:, nope:].mT, 0.3)
    keys = torch.cat((torch.einsum("hnr,bur->bhun", up[:, :nope], kv[..., :rank]),
                      kv[:, None, :, rank:].expand(b, h, s, rope)), dim=-1)
    values = torch.einsum("hvr,bur->bhuv", up[:, nope:], kv[..., :rank])
    query = torch.cat((q_nope, q_pe), dim=-1).transpose(1, 2)
    allowed = torch.zeros(b, s, s, dtype=torch.bool).scatter_(2, idx, True) & torch.ones(s, s, dtype=torch.bool).tril()
    scores = (query @ keys.transpose(-1, -2) * 0.3).masked_fill(~allowed[:, None], float("-inf"))
    want = (torch.softmax(scores, dim=-1) @ values).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _moe_layer(held=None):
    weights = ref.layer_weights(CFG, SEED, 1, CPU, torch.float32)
    cfg = v32.DeepseekV32Config.from_dict(CFG)
    with torch.device("meta"):
        moe = dsv2.DeepseekV2MoE(cfg, 1, held)
    state = {k.removeprefix("mlp."): v.clone() for k, v in weights.items() if k.startswith("mlp.")}
    missing, _ = moe.load_state_dict(state, strict=False, assign=True)
    assert not missing
    return moe.eval(), weights


def test_group_limited_router_matches_transformers_deepseek_v3():
    """The port's route and the reference's choose the experts and weights
    ``transformers``' ``DeepseekV3TopkRouter`` does with 4 groups of 4, the
    best 2 kept, and the whole layer matches the reference's."""
    transformers = pytest.importorskip("transformers")
    if not hasattr(transformers, "DeepseekV3Config"):
        pytest.skip("this transformers has no DeepseekV3Config")
    from transformers.models.deepseek_v3.modeling_deepseek_v3 import DeepseekV3TopkRouter

    moe, w = _moe_layer()
    hf_cfg = transformers.DeepseekV3Config(n_routed_experts=16, num_experts_per_tok=4, n_group=4, topk_group=2,
                                           norm_topk_prob=True, routed_scaling_factor=2.5, hidden_size=64)
    router = DeepseekV3TopkRouter(hf_cfg)
    router.weight.data.copy_(w["mlp.gate.weight"])
    router.e_score_correction_bias.copy_(w["mlp.gate.e_score_correction_bias"])
    x = torch.randn(50, 64, generator=torch.Generator().manual_seed(6))

    def ordered(i, wt):
        order = torch.argsort(i, dim=-1)
        return i.gather(1, order), wt.gather(1, order)

    want_i, want_w = ordered(*router(x))
    got_i, got_w = ordered(*ref.PlainDeepseekV32(CFG, SEED, CPU).route(x, w))
    assert torch.equal(got_i, want_i)
    torch.testing.assert_close(got_w, want_w, rtol=1e-6, atol=1e-7)
    weights, sorted_pairs, offsets, _ = moe.route(x)
    port_i = torch.empty(200, dtype=torch.int64)
    port_i[sorted_pairs] = torch.repeat_interleave(torch.arange(16), torch.diff(offsets, prepend=offsets.new_zeros(1)))
    port_i, port_w = ordered(port_i.view(50, 4), weights)
    assert torch.equal(port_i, want_i)
    torch.testing.assert_close(port_w, want_w, rtol=1e-6, atol=1e-7)
    with torch.no_grad():
        torch.testing.assert_close(moe(x[None])[0], ref.PlainDeepseekV32(CFG, SEED, CPU).moe(x, w), rtol=1e-5, atol=1e-6)


def test_query_lora_attention_matches_transformers_deepseek_v3():
    """Dense latent attention with a query LoRA (``DeepseekV2Attention`` over
    ``q_a_proj``, ``q_a_layernorm`` and ``q_b_proj``) gives what
    ``transformers``' ``DeepseekV3Attention`` gives with the same weights,
    the port's YaRN tables and the causal mask."""
    transformers = pytest.importorskip("transformers")
    if not hasattr(transformers, "DeepseekV3Config"):
        pytest.skip("this transformers has no DeepseekV3Config")
    from transformers.models.deepseek_v3.modeling_deepseek_v3 import DeepseekV3Attention

    cfg = v32.DeepseekV32Config.from_dict(CFG)
    weights = ref.layer_weights(CFG, SEED, 0, CPU, torch.float32)
    with torch.device("meta"):
        attn = dsv2.DeepseekV2Attention(cfg)
    state = {k.removeprefix("self_attn."): v.clone() for k, v in weights.items()
             if k.startswith("self_attn.") and ".indexer." not in k}
    attn.load_state_dict(state, assign=True)
    hf_cfg = transformers.DeepseekV3Config(
        hidden_size=64, num_attention_heads=4, num_key_value_heads=4, q_lora_rank=32, kv_lora_rank=16,
        qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32, rope_scaling=CFG["rope_scaling"], rms_norm_eps=1e-6,
        attention_bias=False, rope_interleave=True)
    hf_cfg._attn_implementation = "eager"
    hf = DeepseekV3Attention(hf_cfg, 0)
    hf.load_state_dict(state)
    s = 40
    x = torch.randn(2, s, 64, generator=torch.Generator().manual_seed(8))
    cos, sin = dsv2.rope_table(cfg, s, CPU)
    tables = (torch.cat((cos, cos), -1)[None].expand(2, s, 16), torch.cat((sin, sin), -1)[None].expand(2, s, 16))
    mask = torch.zeros(s, s).masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1), float("-inf"))[None, None]
    with torch.no_grad():
        want, _ = hf(x, tables, mask.expand(2, 1, s, s))
        got = attn(x, None, cos, sin)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_eight_expert_shares_add_up_to_the_whole_layer():
    """Eight shares of two experts each, each routing over all 16 in their
    groups and computing its own experts' part, add up to the uncut layer
    with the shared expert counted once."""
    whole, _ = _moe_layer()
    shares = [_moe_layer((e, e + 2))[0] for e in range(0, 16, 2)]
    x = torch.randn(3, 20, CFG["hidden_size"], generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        shared = whole.shared_experts(x)
        torch.testing.assert_close(sum(s(x) for s in shares) - 7 * shared, whole(x), rtol=1e-5, atol=1e-6)


# DeepSeek-V2's latent attention and router as they were before the query
# LoRA and group-limited routing were added, kept here to hold the shared
# code to them.
def _attention_before(self, x, bias, cos, sin):
    b, s, _ = x.shape
    h = self.heads
    q = self.q_proj(x).view(b, s, h, -1).transpose(1, 2)
    latent, k_pe = self.kv_a_proj_with_mqa(x).split([self.rank, self.rope], dim=-1)
    kv = self.kv_b_proj(self.kv_a_layernorm(latent)).view(b, s, h, -1).transpose(1, 2)
    k_nope, v = kv.split([self.nope, self.v_dim], dim=-1)
    if cos is None:
        k_pe = k_pe[:, None].expand(b, h, s, self.rope)
    else:
        q_nope, q_pe = q.split([self.nope, self.rope], dim=-1)
        q = torch.cat((q_nope, dsv2.rotate_pairs(q_pe, cos, sin)), dim=-1)
        k_pe = dsv2.rotate_pairs(k_pe[:, None], cos, sin).expand(b, h, s, self.rope)
    k = torch.cat((k_nope, k_pe), dim=-1)
    ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, is_causal=bias is None, scale=self.scale)
    return self.o_proj(ctx.transpose(1, 2).reshape(b, s, h * self.v_dim))


def _route_before(self, x):
    logits = F.linear(x.float(), self.gate.weight.float())
    if self.sigmoid:
        scores = logits.sigmoid()
        idx = torch.topk(scores + self.gate.e_score_correction_bias.float(), self.top_k, dim=-1).indices
        weights = scores.gather(1, idx)
    else:
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


def _dsv2_model(dtype):
    from test_torch_deepseek_v2 import CFG as DSV2, batch as dsv2_batch

    weights = {"model." + k: v for k, v in ref_dsv2.model_weights(DSV2, SEED, CPU, dtype).items()}
    with torch.device("meta"):
        model = dsv2.DeepseekV2Model(dsv2.DeepseekV2Config.from_dict(DSV2))
    return fit_state_dict(model, weights).eval(), dsv2_batch()


def _kimi_model(dtype):
    from test_torch_kimi_linear import CFG as KIMI, batch as kimi_batch

    weights = {"model." + k: v for k, v in ref_kimi.model_weights(KIMI, SEED, CPU, dtype).items()}
    with torch.device("meta"):
        model = kimi.KimiLinearModel(kimi.KimiLinearConfig.from_dict(KIMI))
    return fit_state_dict(model, weights).eval(), kimi_batch()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("family", ["deepseek_v2", "kimi_linear"])
def test_shared_paths_unchanged_bit_for_bit(family, dtype, monkeypatch):
    """DeepSeek-V2-Lite's rope latent attention and softmax route, and
    Kimi-Linear's NoPE latent attention and one-group sigmoid route, give the
    same bits as before the shared code gained the query LoRA and the
    group-limited route."""
    model, (ids, mask) = (_dsv2_model if family == "deepseek_v2" else _kimi_model)(dtype)
    with torch.no_grad():
        now = model(ids, mask)
        monkeypatch.setattr(dsv2.DeepseekV2Attention, "forward", _attention_before)
        monkeypatch.setattr(dsv2.DeepseekV2MoE, "route", _route_before)
        before = model(ids, mask)
    assert torch.equal(now, before)


def _all_earlier_keys(monkeypatch):
    """Attention over every earlier key: the selection ignored."""
    topk = dsa.index_topk
    monkeypatch.setattr(dsa, "index_topk", lambda q, k, w, _: topk(q, k, w, q.shape[1]))


def _relu_dropped(monkeypatch):
    def scores(q, k, w):
        m, heads, d = q.shape
        return torch.bmm(w[:, None], dsa.f32_matmul(q.reshape(m * heads, d), k.T).view(m, heads, -1)).squeeze(1)

    monkeypatch.setattr(dsa, "index_scores", scores)


def _constant_head_weights(monkeypatch):
    scores = dsa.index_scores
    monkeypatch.setattr(dsa, "index_scores", lambda q, k, w: scores(q, k, torch.ones_like(w)))


FAULTS = {"all_earlier_keys": _all_earlier_keys, "relu_dropped": _relu_dropped,
          "constant_head_weights": _constant_head_weights}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails_the_comparison(fault, monkeypatch, plain_f32):
    """Each fault, planted in the port, fails the f32 comparison (1e-5) by at
    least 10 times."""
    FAULTS[fault](monkeypatch)
    assert worst_rel(port(), plain_f32) > 1e-4


def write_checkpoint(path: Path, seed: int = SEED) -> dict:
    """A ``DeepseekV32ForCausalLM`` directory: ``config.json``, the weights
    under the published names (``model.``, ``lm_head`` and a
    multi-token-prediction layer past the last one) in ``model.safetensors``,
    and the seeded byte-level BPE tokenizer."""
    weights = {"model." + k: v for k, v in ref.model_weights(CFG, seed, CPU, torch.float32).items()}
    weights["lm_head.weight"] = torch.randn(CFG["vocab_size"], CFG["hidden_size"])
    mtp = CFG["num_hidden_layers"]
    weights.update({f"model.layers.{mtp}.{k}": torch.randn(2, 2) for k in ("eh_proj.weight", "enorm.weight")})
    words = [w for w in texts.make_vocab(seed, 2000) if w.isalpha()]
    spec = bpe_files.bpe_spec(words, CFG["vocab_size"])
    bpe_files.write_tokenizer_dir(str(path), spec, {**CFG, "architectures": ["DeepseekV32ForCausalLM"]})
    texts.write_safetensors(str(path / "model.safetensors"), weights)
    return spec


def test_families_load_a_checkpoint_and_the_rm_embeds_from_it(tmp_path):
    """``deepseek_v32`` in ``checkpoint.FAMILIES``: the RM reads the
    checkpoint (``lm_head`` and the multi-token-prediction layer dropped, the
    experts stacked) and embeds as the reference does, fed the plain BPE
    encoder's ids; so does the RM over the encoder built and handed over."""
    assert FAMILIES["deepseek_v32"][:2] == (v32.DeepseekV32Config, v32.DeepseekV32Model)
    spec = write_checkpoint(tmp_path)
    docs = ["Alpha beta gamma.", "A much longer text, of several words; with punctuation too, and more of them so "
            "that the selection keeps fewer keys than it sees.", "x"]
    from_dir = TorchSentenceEncoderRM(model=str(tmp_path), max_batch_size=2, max_seq_length=64, device="cpu")
    built = TorchSentenceEncoderRM(model=str(tmp_path), max_batch_size=2, max_seq_length=64, device="cpu",
                                   encoder=port())
    assert isinstance(from_dir.encoder, v32.DeepseekV32Model) and not hasattr(from_dir.encoder, "lm_head")
    assert len(from_dir.encoder.layers) == CFG["num_hidden_layers"]
    bpe = ByteBPE(spec, bpe_files.BOS)
    ids = [bpe.encode(d, 64) for d in docs]
    assert max(map(len, ids)) > CFG["index_topk"]
    expected = ref.PlainDeepseekV32(CFG, SEED, CPU, torch.float32).embed(ids)
    for rm in (from_dir, built):
        np.testing.assert_allclose(rm(docs), expected, atol=2e-6)


def test_config_refuses_what_the_port_does_not_run():
    with pytest.raises(NotImplementedError, match="q_lora_rank"):
        v32.DeepseekV32Config.from_dict({**CFG, "q_lora_rank": None})
    with pytest.raises(NotImplementedError, match="index_head_dim"):
        v32.DeepseekV32Config.from_dict({**CFG, "index_head_dim": 8})
    for bad in ({"n_group": 3}, {"topk_group": 5}, {"n_group": 16, "topk_group": 1}):
        with pytest.raises(NotImplementedError, match="n_group"):
            v32.DeepseekV32Config.from_dict({**CFG, **bad})
    with pytest.raises(NotImplementedError, match="topk_method"):
        v32.DeepseekV32Config.from_dict({**CFG, "scoring_func": "softmax"})
    cfg = v32.DeepseekV32Config.from_dict(CFG)
    assert (cfg.n_group, cfg.topk_group, cfg.index_topk, cfg.index_n_heads) == (4, 2, 16, 16)
    assert [i for i in range(3) if cfg.is_moe(i)] == [1, 2]


SPANS = {"rm.call", "rm.tokenize", "rm.forward", "mla.attn", "dsa.index", "dsa.attn", "moe.route", "moe.experts",
         "moe.shared", "moe.combine"}


def test_spans_and_counters_cost_one_flag_check(tmp_path, monkeypatch):
    """With no profiler running each span site and each layer's counter
    check the profiler's flag once and record nothing; under a profiler the
    spans are recorded and the counters hold, per layer, the causal pairs
    scored, the pairs selected and the query rows, padding included."""
    write_checkpoint(tmp_path)
    rm = TorchSentenceEncoderRM(model=str(tmp_path), max_batch_size=2, max_seq_length=64, device="cpu")
    docs = ["Alpha beta gamma.", "Delta epsilon zeta eta theta iota kappa lambda mu nu xi omicron pi rho sigma.",
            "Zeta eta theta iota."]
    checks = []
    flag = profiling._profiler_enabled
    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: checks.append(1) or flag())
    monkeypatch.setattr(profiling, "_Span", None)  # any span object made would raise
    monkeypatch.setattr(profiling, "tally", None)
    rm(docs)
    batches, layers = 2, CFG["num_hidden_layers"]
    per_forward = 1 + 4 * layers + 5 * MOE_LAYERS
    assert len(checks) == 1 + (batches + 1) + batches * per_forward
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]):
        rm(docs)
    totals = profiling.span_totals()
    assert SPANS <= set(totals) and totals["rm.forward"].calls == batches
    assert totals["mla.attn"].calls == totals["dsa.index"].calls == totals["dsa.attn"].calls == batches * layers
    counters = profiling.counter_totals()
    shapes = [tuple(ids.shape) for _, ids, _ in _batches(rm, docs)]
    assert max(s for _, s in shapes) > CFG["index_topk"]
    want = {"dsa.scored": sum(b * s * (s + 1) // 2 for b, s in shapes),
            "dsa.pairs": sum(b * dsa.causal_selections(s, CFG["index_topk"]) for b, s in shapes),
            "dsa.queries": sum(b * s for b, s in shapes)}
    for name, n in want.items():
        assert counters[name].shape == (layers, 1) and counters[name][:, 0].tolist() == [n] * layers, name


def _batches(rm, docs):
    from lotus_tpu_torch.models.torch_rm import bucketed_batches

    return list(bucketed_batches(rm.tokenizer, docs, None, rm.max_batch_size, rm.max_seq_length, rm.device))
