"""A plain DeepSeek-V3.2-Exp forward in f32 with TF32 off, mean pooling and
L2 normalisation, and the seeded weights it shares with the program.

It follows the published inference code (``inference/model.py`` of
``deepseek-ai/DeepSeek-V3.2-Exp``: ``Indexer``, ``MLA`` and ``Gate``), for a
text's normed layer input x and query t:

- the query LoRA: qr = RMSNorm(q_a_proj x), q = q_b_proj qr, each head's
  nope and rope parts; the latent, its RMSNorm, the one rope key shared by
  the heads and ``kv_b_proj`` as in DeepSeek-V2's reference
  (``deepseek_v2.py``): the rope de-interleaved and rotated by
  ``rotate_half`` at YaRN's frequencies;
- the indexer: qi = wq_b qr (heads x dim), ki = LayerNorm(wk x) (weight and
  bias, eps 1e-6), the first rope channels of each rotated by
  ``rotate_half`` as they lie (not de-interleaved), w = weights_proj x /
  sqrt(heads); I(t, s) = dim^-0.5 sum_h w_h ReLU(qi_h . ki_s) for s <= t and
  -inf past t; the selection is ``topk(min(index_topk, end))`` of that row,
  as the published code takes it (a row with t + 1 < index_topk picks up
  later positions too, which the causal mask removes);
- MLA's scores in the non-absorbed form, q . k x (nope + rope)^-0.5
  mscale^2, plus 0 on the selection and -inf off it and past t, the
  softmax, times the values, then ``o_proj``;
- the dense SwiGLU MLP of the first ``first_k_dense_replace`` layers; then
  the router: the sigmoid of f32 logits, plus ``e_score_correction_bias`` to
  choose, the ``n_group`` groups scored by the sum of their two best, the
  ``topk_group`` best kept and the others' experts masked to -inf, the
  top-k, the uncorrected scores of the chosen renormalised (+1e-20) and
  times ``routed_scaling_factor``; each held routed expert run on its own
  tokens one at a time, plus the shared expert.

Departures, each the same arithmetic: every text runs alone at its own
length, with no padding; attention runs in blocks of query rows, each over
the keys up to its last row.  The indexer runs in f32 without the published
code's Hadamard rotation and fp8 rounding of qi and ki (an orthonormal
rotation of both leaves every product unchanged).  Only the held experts
(``n_routed_experts``, the chip's share of ``router_experts``) have
weights: pairs routed to the others add nothing, as on one chip of the
expert-parallel deployment.  ``fp8`` rounds every linear layer's inputs
and weights per row to fp8 e4m3 (the indexer's projections, the router and
the experts included; the index and attention products stay f32): the
control, one precision below the configuration's bf16.  ``probe`` asks, for
each text, the query rows of layer 0 whose selection and attention output
(``o_proj``'s) are kept in ``probed``.

Weights (``layer_weights``): per layer, every matrix from one N(0, 0.02)
draw (``deepseek_v2._draw``), norm weights 1 (the RMSNorms' and
``k_norm``'s); from a second draw of the layer's own seed, ``k_norm``'s
bias N(0, 0.02) and ``e_score_correction_bias`` N(0, 0.05); each rounded
to the served dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import deepseek_v2 as dsv2
from perfbench.reference.topk import f32_exact

QUERY_BLOCK = 256  # query rows a block of attention
INDEX_NORM_EPS = 1e-6
SECOND_STD = {"indexer.k_norm.bias": 0.02, "e_score_correction_bias": 0.05}


def router_experts(cfg: dict) -> int:
    """The router's outputs: ``router_experts``, or every expert."""
    return cfg.get("router_experts", cfg["n_routed_experts"])


def layer_shapes(cfg: dict, i: int) -> tuple[dict[str, tuple[int, ...]], dict[str, tuple[int, ...]]]:
    """Layer ``i``'s parameters by their checkpoint names under
    ``layers.<i>.``: (the matrices and norms of the normal draw, the
    parameters of the second draw)."""
    h, heads, qr = cfg["hidden_size"], cfg["num_attention_heads"], cfg["q_lora_rank"]
    nope, rope, v, rank = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    ih, idim = cfg["index_n_heads"], cfg["index_head_dim"]
    a = "self_attn."
    s: dict[str, tuple[int, ...]] = {"input_layernorm.weight": (h,), "post_attention_layernorm.weight": (h,)}
    s[a + "q_a_proj.weight"] = (qr, h)
    s[a + "q_a_layernorm.weight"] = (qr,)
    s[a + "q_b_proj.weight"] = (heads * (nope + rope), qr)
    s[a + "kv_a_proj_with_mqa.weight"] = (rank + rope, h)
    s[a + "kv_a_layernorm.weight"] = (rank,)
    s[a + "kv_b_proj.weight"] = (heads * (nope + v), rank)
    s[a + "o_proj.weight"] = (h, heads * v)
    s[a + "indexer.wq_b.weight"] = (ih * idim, qr)
    s[a + "indexer.wk.weight"] = (idim, h)
    s[a + "indexer.k_norm.weight"] = (idim,)
    s[a + "indexer.weights_proj.weight"] = (ih, h)
    extra: dict[str, tuple[int, ...]] = {a + "indexer.k_norm.bias": (idim,)}
    if dsv2.is_moe(cfg, i):
        w = cfg["moe_intermediate_size"]
        s["mlp.gate.weight"] = (router_experts(cfg), h)
        extra["mlp.gate.e_score_correction_bias"] = (router_experts(cfg),)
        for e in range(cfg["n_routed_experts"]):
            s[f"mlp.experts.{e}.gate_proj.weight"] = s[f"mlp.experts.{e}.up_proj.weight"] = (w, h)
            s[f"mlp.experts.{e}.down_proj.weight"] = (h, w)
        ws = w * cfg["n_shared_experts"]
        s["mlp.shared_experts.gate_proj.weight"] = s["mlp.shared_experts.up_proj.weight"] = (ws, h)
        s["mlp.shared_experts.down_proj.weight"] = (h, ws)
    else:
        f = cfg["intermediate_size"]
        s["mlp.gate_proj.weight"] = s["mlp.up_proj.weight"] = (f, h)
        s["mlp.down_proj.weight"] = (h, f)
    return s, extra


def _second_draw(shapes: dict[str, tuple[int, ...]], seed: int, device: torch.device, dtype: torch.dtype
                 ) -> dict[str, torch.Tensor]:
    g = torch.Generator(device=device).manual_seed(seed)
    std = {name: next(v for k, v in SECOND_STD.items() if name.endswith(k)) for name in shapes}
    return {name: (std[name] * torch.randn(shape, generator=g, device=device)).to(dtype)
            for name, shape in shapes.items()}


def layer_weights(cfg: dict, seed: int, i: int, device: torch.device, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """Layer ``i``'s weights, named as ``layer_shapes`` names them."""
    shapes, extra = layer_shapes(cfg, i)
    part = dsv2.weight_seed(seed, i + 1)
    return {**dsv2._draw(shapes, part, device, dtype), **_second_draw(extra, part ^ 1, device, dtype)}


def model_weights(cfg: dict, seed: int, device: torch.device, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """Every weight under ``DeepseekV32Model``'s names (small models only)."""
    out = dsv2.embedding_weights(cfg, seed, device, dtype)
    for i in range(cfg["num_hidden_layers"]):
        out.update({f"layers.{i}.{k}": v for k, v in layer_weights(cfg, seed, i, device, dtype).items()})
    return out


def index_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The indexer's rope on (..., d) ``x``: its first rope channels rotated
    by ``rotate_half`` as they lie, by (broadcast) ``cat(freqs, freqs)``
    tables, the rest unchanged."""
    rope = cos.shape[-1]
    return torch.cat((x[..., :rope] * cos + dsv2.rotate_half(x[..., :rope]) * sin, x[..., rope:]), dim=-1)


class PlainDeepseekV32(dsv2.PlainDeepseekV2):
    """The forward over texts given as token ids (every id real), weights
    remade from ``seed`` one layer at a time on ``device``.  ``probe`` gives,
    for each text, the query rows of layer 0 to keep (or None); after
    ``hidden`` each probed text's (selection (rows, index_topk) sorted,
    attention output (rows, hidden)) is in ``probed``."""

    def __init__(self, cfg: dict, seed: int, device: torch.device, dtype: torch.dtype = torch.bfloat16,
                 fp8: bool = False, probe: list | None = None):
        super().__init__(cfg, seed, device, dtype, fp8)
        self.probe = probe
        self.probed: list[tuple[torch.Tensor, torch.Tensor]] = []

    def indexer(self, x: torch.Tensor, qr: torch.Tensor, w: dict[str, torch.Tensor], cos: torch.Tensor,
                sin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One text's index queries (s, heads, dim), keys (s, dim) and head
        weights (s, heads), the scales folded into the weights."""
        cfg, p = self.cfg, "self_attn.indexer."
        ih, idim = cfg["index_n_heads"], cfg["index_head_dim"]
        qi = index_rope(self._linear(qr, w[p + "wq_b.weight"]).view(-1, ih, idim), cos[:, None], sin[:, None])
        ki = F.layer_norm(self._linear(x, w[p + "wk.weight"]), (idim,), w[p + "k_norm.weight"], w[p + "k_norm.bias"],
                          INDEX_NORM_EPS)
        hw = self._linear(x, w[p + "weights_proj.weight"]) * (ih**-0.5 * idim**-0.5)
        return qi, index_rope(ki, cos, sin), hw

    def attention(self, x: torch.Tensor, w: dict[str, torch.Tensor], rows: torch.Tensor | None = None
                  ) -> torch.Tensor:
        """One text's sparse latent attention, (s, hidden) -> (s, hidden);
        with ``rows``, their selection and output are appended to ``probed``."""
        cfg, a = self.cfg, "self_attn."
        s, heads = x.shape[0], cfg["num_attention_heads"]
        nope, rope, vd, rank = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
        qr = self._rms(self._linear(x, w[a + "q_a_proj.weight"]), w[a + "q_a_layernorm.weight"])
        q = self._linear(qr, w[a + "q_b_proj.weight"]).view(s, heads, nope + rope).transpose(0, 1)
        ckv = self._linear(x, w[a + "kv_a_proj_with_mqa.weight"])
        latent, k_pe = ckv[:, :rank], ckv[:, rank:]
        kv = self._linear(self._rms(latent, w[a + "kv_a_layernorm.weight"]), w[a + "kv_b_proj.weight"])
        kv = kv.view(s, heads, nope + vd).transpose(0, 1)
        cos, sin = dsv2.rope_cos_sin(cfg, s, x.device)
        query = torch.cat((q[..., :nope], dsv2.apply_rope(q[..., nope:], cos, sin)), dim=-1)
        key = torch.cat((kv[..., :nope], dsv2.apply_rope(k_pe[None], cos, sin).expand(heads, s, rope)), dim=-1)
        value = kv[..., nope:]
        qi, ki, hw = self.indexer(x, qr, w, cos, sin)
        topk, scale = cfg["index_topk"], dsv2.softmax_scale(cfg)
        ctx = torch.empty(heads, s, vd, dtype=x.dtype, device=x.device)
        kept = []
        for lo in range(0, s, QUERY_BLOCK):
            hi = min(lo + QUERY_BLOCK, s)
            causal = torch.arange(hi, device=x.device)[None] <= torch.arange(lo, hi, device=x.device)[:, None]
            index = torch.einsum("thd,ud->thu", qi[lo:hi], ki[:hi]).relu_().mul_(hw[lo:hi, :, None]).sum(1)
            sel = index.masked_fill_(~causal, float("-inf")).topk(min(topk, hi), dim=-1).indices
            allowed = torch.zeros_like(causal).scatter_(1, sel, True) & causal
            scores = (query[:, lo:hi] @ key[:, :hi].transpose(-1, -2)).mul_(scale)
            ctx[:, lo:hi] = torch.softmax(scores.masked_fill_(~allowed, float("-inf")), dim=-1) @ value[:, :hi]
            here = rows[(rows >= lo) & (rows < hi)] if rows is not None else ()
            if len(here):
                kept.append(sel[here - lo].sort(dim=-1).values)
        out = self._linear(ctx.transpose(0, 1).reshape(s, heads * vd), w[a + "o_proj.weight"])
        if rows is not None:
            self.probed.append((torch.cat(kept), out[rows]))
        return out

    def route(self, x: torch.Tensor, w: dict[str, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        """The group-limited sigmoid router: each token's (t, k) chosen
        experts and their weights."""
        cfg = self.cfg
        scores = torch.sigmoid(self._linear(x, w["mlp.gate.weight"]))
        choice = scores + w["mlp.gate.e_score_correction_bias"]
        groups = cfg.get("n_group") or 1
        if groups > 1:
            grouped = choice.view(x.shape[0], groups, -1)
            best = grouped.topk(2, dim=-1).values.sum(-1).topk(cfg["topk_group"], dim=-1).indices
            dropped = torch.ones(grouped.shape[:2], dtype=torch.bool, device=x.device).scatter_(1, best, False)
            choice = grouped.masked_fill(dropped[..., None], float("-inf")).flatten(1)
        top_i = torch.topk(choice, cfg["num_experts_per_tok"], dim=-1).indices
        top_w = scores.gather(1, top_i)
        if cfg.get("norm_topk_prob"):
            top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-20)
        return top_i, top_w * cfg.get("routed_scaling_factor", 1.0)

    def moe(self, x: torch.Tensor, w: dict[str, torch.Tensor]) -> torch.Tensor:
        """The router, the held routed experts one at a time over their
        tokens, plus the shared expert, (t, hidden) -> (t, hidden)."""
        k = self.cfg["num_experts_per_tok"]
        top_i, top_w = self.route(x, w)
        y = torch.zeros_like(x)
        flat = top_i.reshape(-1)
        for e in range(self.cfg["n_routed_experts"]):
            pairs = torch.nonzero(flat == e).flatten()
            if len(pairs):
                tokens = pairs // k
                y.index_add_(0, tokens, self._mlp(x[tokens], w, f"mlp.experts.{e}.") * top_w.reshape(-1)[pairs, None])
        return y + self._mlp(x, w, "mlp.shared_experts.")

    def hidden(self, token_ids: list[list[int]]) -> list[torch.Tensor]:
        """Each text's last hidden states (its length, hidden), f32; the
        texts run one at a time through each layer."""
        f32_exact()
        cfg = self.cfg
        probe = self.probe or [None] * len(token_ids)
        self.probed = []
        with torch.inference_mode():
            emb = self._weights(dsv2.embedding_weights(cfg, self.seed, self.device, self.dtype))
            xs = [emb["embed_tokens.weight"][torch.tensor(t, dtype=torch.int64, device=self.device)]
                  for t in token_ids]
            for i in range(cfg["num_hidden_layers"]):
                w = self._weights(layer_weights(cfg, self.seed, i, self.device, self.dtype))
                for j, x in enumerate(xs):
                    rows = None if i or probe[j] is None else torch.as_tensor(probe[j], device=self.device)
                    x = x + self.attention(self._rms(x, w["input_layernorm.weight"]), w, rows)
                    normed = self._rms(x, w["post_attention_layernorm.weight"])
                    xs[j] = x + (self.moe(normed, w) if dsv2.is_moe(cfg, i) else self._mlp(normed, w, "mlp."))
                del w
            return [self._rms(x, emb["norm.weight"]) for x in xs]
