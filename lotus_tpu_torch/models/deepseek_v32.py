"""DeepSeek-V3.2-Exp as ``nn.Module``s (an RM only), under the published
checkpoint's names (``deepseek-ai/DeepSeek-V3.2-Exp``; the layer's
equations are its ``inference/model.py``'s ``Indexer`` and ``MLA``):

- DeepSeek-V2's decoder (``deepseek_v2.py``): token embeddings, per layer
  RMSNorm, attention, residual, RMSNorm, the MLP, residual; a final
  ``norm``; dense SwiGLU in the first ``first_k_dense_replace`` layers, then
  ``deepseek_v2.DeepseekV2MoE`` with DeepSeek-V3's router (sigmoid scores
  plus ``e_score_correction_bias`` choosing the top ``num_experts_per_tok``
  within the best ``topk_group`` of ``n_group`` groups, the uncorrected
  scores renormalised, times ``routed_scaling_factor``) and the shared
  expert;
- latent attention with a query LoRA: ``qr = q_a_layernorm(q_a_proj(x))``,
  ``q_b_proj(qr)`` each head's nope and rope query; the latent, the shared
  rope key and the up-projections (``kv_b_proj``) as DeepSeek-V2's; the rope
  interleaved at YaRN's frequencies, the softmax scale
  (nope + rope)^-0.5 mscale^2;
- DeepSeek Sparse Attention in every layer: the lightning indexer
  (``self_attn.indexer``) scores every earlier token for each query,
  I(t, s) = index_head_dim^-0.5 sum_h w[t, h] ReLU(qi[t, h] . ki[s]) with
  ``qi = wq_b(qr)`` (``index_n_heads`` x ``index_head_dim``), ``ki =
  k_norm(wk(x))`` (a LayerNorm with bias, eps 1e-6, in f32) and ``w =
  weights_proj(x) * index_n_heads^-0.5``; the first ``qk_rope_head_dim``
  channels of qi and ki are rotated at MLA's frequencies, not interleaved
  (channel i with channel i + rope / 2); each query attends only to its top
  ``min(index_topk, t + 1)`` keys by I (``ops/dsa.py``: the scores in f32
  from the bf16 projections, the attention in its absorbed form), which is
  dense causal attention where t < ``index_topk``.

Departures: the published code quantises the indexer's q and k to fp8 after
a Hadamard rotation; the rotation is orthonormal and applied to both, so in
exact arithmetic it leaves every qi . ki unchanged, and the port runs the
indexer in the model's dtype without either step.  The checkpoint's fp8
weights and their ``weight_scale_inv`` are not read (the loader takes bf16
or f32 tensors).  Not held: ``lm_head`` and the multi-token-prediction layer
(``model.layers.<num_hidden_layers>``), which an embedder does not run; the
loader ignores them.  Names this port could not confirm against the
published checkpoint and took from the inference code and DeepSeek-V3's:
``self_attn.indexer.{wq_b, wk, k_norm, weights_proj}`` (the inference
code's own), ``k_norm.bias``, the routed experts'
``mlp.experts.<e>.{gate,up,down}_proj`` and the gate's
``e_score_correction_bias``.

A layer is told which experts it holds (``experts=(first, end)``) and routes
over every expert, as on one chip of an expert-parallel deployment.  The
model reads no attention mask: a row's pads must come after its real tokens
(right padding, as this family's tokenizer pads), which causality keeps out
of the real rows' scores and selections.  The forward makes no host
synchronisation.  Spans (``lotus_tpu_torch.profiling``): ``mla.attn`` (a
layer's attention, its input norm and projections included) over
``dsa.index`` (the indexer's projections, scores and top-k) and
``dsa.attn`` (attention over the selection), and the MoE layer's; counters,
per layer, padding included: ``dsa.scored`` the causal (query, key) pairs
the indexer scored, ``dsa.pairs`` the selected pairs attended and
``dsa.queries`` the query rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch
import torch.nn.functional as F
from torch import nn

from lotus_tpu_torch import profiling
from lotus_tpu_torch.models.bart import check_length
from lotus_tpu_torch.models.deepseek_v2 import (
    DeepseekV2Attention, DeepseekV2Config, DeepseekV2MoE, rope_table, rotate_pairs,
)
from lotus_tpu_torch.models.llama import LlamaMLP, LlamaRMSNorm
from lotus_tpu_torch.ops import dsa

INDEX_NORM_EPS = 1e-6


@dataclass(frozen=True, eq=False)
class DeepseekV32Config(DeepseekV2Config):
    """The fields of a DeepSeek-V3.2 ``config.json`` the forward reads."""

    model_types: ClassVar[tuple[str, ...]] = ("deepseek_v32",)

    index_n_heads: int = 64
    index_head_dim: int = 128
    index_topk: int = 2048

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.q_lora_rank is None:
            raise NotImplementedError("q_lora_rank null: DeepSeek Sparse Attention's indexer reads the query "
                                      "LoRA's latent, so the port runs deepseek_v32 with one")
        if self.qk_rope_head_dim % 2 or self.index_head_dim < self.qk_rope_head_dim:
            raise NotImplementedError(f"index_head_dim {self.index_head_dim} with qk_rope_head_dim "
                                      f"{self.qk_rope_head_dim}: the indexer rotates its first rope channels in "
                                      f"halves")


def rotate_halves(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x`` (..., d) with its first 2 x half channels rotated in f32 as the
    pairs (i, i + half) by ``cos`` / ``sin`` (broadcast to (..., half)),
    the rest as they are, cast back."""
    half = cos.shape[-1]
    a, b = x[..., :half].float(), x[..., half : 2 * half].float()
    rotated = torch.cat((a * cos - b * sin, a * sin + b * cos), dim=-1).to(x.dtype)
    return torch.cat((rotated, x[..., 2 * half :]), dim=-1)


class IndexerKeyNorm(nn.Module):
    """The indexer's key LayerNorm (``weight``, ``bias``), computed in f32."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight.float(), self.bias.float(),
                            INDEX_NORM_EPS).to(x.dtype)


class Indexer(nn.Module):
    """The lightning indexer: (b, s, hidden) ``x`` and the query LoRA's (b, s,
    q_lora_rank) ``qr`` to the (b, s, min(index_topk, s)) selection
    (``dsa.index_topk``)."""

    def __init__(self, cfg: DeepseekV32Config):
        super().__init__()
        self.heads, self.dim, self.topk = cfg.index_n_heads, cfg.index_head_dim, cfg.index_topk
        self.wq_b = nn.Linear(cfg.q_lora_rank, self.heads * self.dim, bias=False)
        self.wk = nn.Linear(cfg.hidden_size, self.dim, bias=False)
        self.k_norm = IndexerKeyNorm(self.dim)
        self.weights_proj = nn.Linear(cfg.hidden_size, self.heads, bias=False)

    def forward(self, x: torch.Tensor, qr: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        q = rotate_halves(self.wq_b(qr).view(b, s, self.heads, self.dim), cos[:, None], sin[:, None])
        k = rotate_halves(self.k_norm(self.wk(x)), cos, sin)
        w = self.weights_proj(x).float().mul_((self.heads * self.dim) ** -0.5)
        return dsa.index_topk(q, k, w, self.topk)


class DeepseekV32Attention(DeepseekV2Attention):
    """Latent attention with a query LoRA over the indexer's selection."""

    def __init__(self, cfg: DeepseekV32Config, layer: int):
        super().__init__(cfg)
        self.layer, self.layers = layer, cfg.num_hidden_layers
        self.indexer = Indexer(cfg)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        h = self.heads
        qr = self.q_a_layernorm(self.q_a_proj(x))
        q_nope, q_pe = self.q_b_proj(qr).view(b, s, h, -1).split([self.nope, self.rope], dim=-1)
        q_pe = rotate_pairs(q_pe, cos[:, None], sin[:, None])
        latent, k_pe = self.kv_a_proj_with_mqa(x).split([self.rank, self.rope], dim=-1)
        kv = torch.cat((self.kv_a_layernorm(latent), rotate_pairs(k_pe, cos, sin)), dim=-1)
        with profiling.annotate("dsa.index", layer=self.layer):
            idx = self.indexer(x, qr, cos, sin)
        if profiling.active():
            topk = idx.shape[-1]
            for name, n in (("dsa.scored", s * (s + 1) // 2), ("dsa.pairs", dsa.causal_selections(s, topk)),
                            ("dsa.queries", s)):
                profiling.tally(name, self.layer, torch.full((1,), b * n, dtype=torch.int64, device=x.device),
                                self.layers)
        up = self.kv_b_proj.weight.view(h, self.nope + self.v_dim, self.rank)
        with profiling.annotate("dsa.attn", layer=self.layer):
            ctx = dsa.sparse_attention(q_nope, q_pe, kv, idx, up[:, : self.nope], up[:, self.nope :].mT, self.scale)
        return self.o_proj(ctx.reshape(b, s, h * self.v_dim))


class DeepseekV32DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepseekV32Config, layer: int, experts: tuple[int, int] | None = None):
        super().__init__()
        self.layer = layer
        self.input_layernorm = LlamaRMSNorm(cfg)
        self.self_attn = DeepseekV32Attention(cfg, layer)
        self.post_attention_layernorm = LlamaRMSNorm(cfg)
        self.mlp = DeepseekV2MoE(cfg, layer, experts) if cfg.is_moe(layer) else LlamaMLP(cfg)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        with profiling.annotate("mla.attn", layer=self.layer):
            x = x + self.self_attn(self.input_layernorm(x), cos, sin)
        return x + self.mlp(self.post_attention_layernorm(x))


class DeepseekV32Model(nn.Module):
    """The decoder: ``forward`` gives the last hidden state (b, s, hidden)
    after ``norm``.  ``experts`` = (first, end) are the routed experts each
    MoE layer holds (all by default); each routes over ``n_routed_experts``."""

    base_model_prefix = "model"

    def __init__(self, cfg: DeepseekV32Config, experts: tuple[int, int] | None = None):
        super().__init__()
        self.config = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(DeepseekV32DecoderLayer(cfg, i, experts) for i in range(cfg.num_hidden_layers))
        self.norm = LlamaRMSNorm(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        s = input_ids.shape[1]
        check_length(self.config, s)
        x = self.embed_tokens(input_ids)
        cos, sin = rope_table(self.config, s, input_ids.device)
        for layer in self.layers:
            x = layer(x, cos, sin)
        return self.norm(x)
