"""DeepSeek-V2 as ``nn.Module``s, under Hugging Face's names (an RM only),
from the published modeling code (``modeling_deepseek.py`` of
``deepseek-ai/DeepSeek-V2-Lite``, which ``transformers.models.deepseek_v2``
re-implements):

- token embeddings ``embed_tokens``; positions enter only through rotary
  embeddings at ``arange(seq)``; per layer RMSNorm (``input_layernorm``,
  ``llama.LlamaRMSNorm``), latent attention, residual, RMSNorm
  (``post_attention_layernorm``), the MLP, residual; a final ``norm``;
- latent attention (MLA): ``q_proj`` gives each head ``qk_nope_head_dim`` +
  ``qk_rope_head_dim`` (``q_lora_rank`` null, as in DeepSeek-V2-Lite), or
  with a query LoRA (``q_lora_rank`` set, as in DeepSeek-V3) ``q_b_proj``
  over ``q_a_layernorm`` (RMSNorm) of ``q_a_proj`` gives them;
  ``kv_a_proj_with_mqa`` gives the latent
  (``kv_lora_rank``) and one rope key shared by every head; ``kv_b_proj``
  over ``kv_a_layernorm`` of the latent gives each head its key part and
  value.  The rope part of query and key is rotated in interleaved pairs
  (``transformers``' complex pairs; the remote code's de-interleave and
  ``rotate_half`` give the same scores); with ``rope_scaling`` of type
  ``yarn`` the frequencies are YaRN's blend (a linear ramp between
  ``beta_fast`` and ``beta_slow`` over ``original_max_position_embeddings``)
  and the softmax scale is ``(nope + rope)^-0.5 * mscale(factor,
  mscale_all_dim)^2``, as the remote code has it (``transformers`` 4.57
  leaves the mscale out).  Scores and softmax run in f32 inside
  ``scaled_dot_product_attention`` over the causal and padding masks
  combined into one ``finfo.min`` bias (``gpt2.decoder_bias``);
- the MLP is dense SwiGLU (``llama.LlamaMLP``) in the first
  ``first_k_dense_replace`` layers (and off the ``moe_layer_freq`` period),
  else the mixture of experts: the gate's logits in f32, softmax, greedy
  top-``num_experts_per_tok`` (renormalised only under ``norm_topk_prob``),
  times ``routed_scaling_factor``; or (``topk_method`` ``noaux_tc`` with
  ``scoring_func`` ``sigmoid`` over one group, DeepSeek-V3's router as
  ``transformers``' ``DeepseekV3TopkRouter`` has it, which Kimi-Linear's
  ``kimi_linear.py`` uses) the sigmoid of the logits plus the gate's
  ``e_score_correction_bias`` chooses the experts (over ``n_group`` groups,
  DeepSeek-V3's group-limited choice: a group scores the sum of its two best
  corrected scores, the best ``topk_group`` groups are kept and the others'
  experts masked to -inf before the top-k, as the published inference code
  has it), and the uncorrected
  sigmoid scores of the chosen ones are their weights, renormalised under
  ``norm_topk_prob``, times the factor; the (token, expert) pairs sorted by
  expert with offsets counted on the device, the held experts' SwiGLU as two
  grouped GEMMs (``torch._grouped_mm``), then the combine (K4,
  ``ops/moe_combine.py``): each token's outputs gathered back through the
  sort's inverse, weighted and summed in f32 with the shared experts' output
  (one SwiGLU MLP of ``n_shared_experts`` x ``moe_intermediate_size``) and
  rounded once.

Without rotary tables (``cos`` and ``sin`` None: Kimi-Linear's
``mla_use_nope``) the latent attention rotates nothing: the rope parts of
query and key enter the scores as they are projected, the shared key part
concatenated unrotated, and, with no bias either, the scores are causal
alone (``is_causal``), which holds for right-padded rows.

A layer is told which experts it holds (``experts=(first, end)``, all of
them by default) and routes over every expert: pairs sent to an expert it
does not hold add nothing here, as on one chip of an expert-parallel
deployment.  The forward makes no host synchronisation.  The checkpoint's
per-expert ``mlp.experts.<e>.{gate,up,down}_proj.weight`` are stacked as
they load (``GroupedExperts``); ``lm_head`` is dropped by the loader.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar

import torch
import torch.nn.functional as F
from torch import nn

from lotus_tpu_torch import profiling
from lotus_tpu_torch.models.bart import check_length
from lotus_tpu_torch.models.bert import ACTIVATIONS, EncoderConfig
from lotus_tpu_torch.models.gpt2 import causal, decoder_bias
from lotus_tpu_torch.models.llama import LlamaMLP, LlamaRMSNorm
from lotus_tpu_torch.ops.moe_combine import moe_combine


@dataclass(frozen=True, eq=False)
class DeepseekV2Config(EncoderConfig):
    """The fields of a DeepSeek-V2 ``config.json`` the forward reads (the
    defaults are the remote code's ``DeepseekV2Config``'s)."""

    model_types: ClassVar[tuple[str, ...]] = ("deepseek_v2",)

    vocab_size: int = 102400
    hidden_size: int = 4096
    intermediate_size: int = 11008
    moe_intermediate_size: int = 1407
    num_hidden_layers: int = 30
    num_attention_heads: int = 32
    n_shared_experts: int | None = None
    n_routed_experts: int | None = None
    routed_scaling_factor: float = 1.0
    topk_method: str = "greedy"
    num_experts_per_tok: int | None = None
    moe_layer_freq: int = 1
    first_k_dense_replace: int = 0
    norm_topk_prob: bool = False
    scoring_func: str = "softmax"
    n_group: int | None = None
    topk_group: int | None = None
    q_lora_rank: int | None = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    hidden_act: str = "silu"
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling: dict | None = None
    attention_bias: bool = False
    num_labels: int = 2

    def __post_init__(self) -> None:
        if (self.topk_method, self.scoring_func) not in ROUTERS:
            raise NotImplementedError(f"topk_method {self.topk_method!r} with scoring_func {self.scoring_func!r}: "
                                      f"the port runs greedy top-k over a softmax (DeepSeek-V2-Lite's) or "
                                      f"noaux_tc over sigmoid scores (DeepSeek-V3's and Kimi-Linear's)")
        groups, kept = self.n_group or 1, self.topk_group or 1
        if self.topk_method == "noaux_tc" and groups > 1 and (
                self.n_routed_experts % groups or self.n_routed_experts // groups < 2 or not 1 <= kept <= groups
                or kept * (self.n_routed_experts // groups) < self.num_experts_per_tok):
            raise NotImplementedError(f"n_group {self.n_group} / topk_group {self.topk_group} over "
                                      f"{self.n_routed_experts} experts: the port runs noaux_tc over equal groups "
                                      f"of at least two experts, keeping enough groups for the top-k")
        kind = (self.rope_scaling or {}).get("type", (self.rope_scaling or {}).get("rope_type"))
        if kind not in (None, "yarn"):
            raise NotImplementedError(f"rope_scaling type {kind!r}: the port runs none or 'yarn'")

    def is_moe(self, layer: int) -> bool:
        return (self.n_routed_experts is not None and layer >= self.first_k_dense_replace
                and layer % self.moe_layer_freq == 0)

    @property
    def softmax_scale(self) -> float:
        scale = (self.qk_nope_head_dim + self.qk_rope_head_dim) ** -0.5
        rs = self.rope_scaling or {}
        if rs.get("mscale_all_dim"):
            m = yarn_mscale(rs["factor"], rs["mscale_all_dim"])
            scale *= m * m
        return scale


ROUTERS = (("greedy", "softmax"), ("noaux_tc", "sigmoid"))


def yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def rope_table(cfg: DeepseekV2Config, s: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (s, rope dim / 2) f32, made on ``device`` (no copy
    from the host): YaRN's frequencies where ``rope_scaling`` says so, each
    scaled by mscale(factor, mscale) / mscale(factor, mscale_all_dim)."""
    dim, base, rs = cfg.qk_rope_head_dim, cfg.rope_theta, cfg.rope_scaling or {}
    pos_freqs = base ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    inv_freq, attention = 1.0 / pos_freqs, 1.0
    if rs:
        factor, orig = rs["factor"], rs.get("original_max_position_embeddings") or cfg.max_position_embeddings

        def correction_dim(rotations: float) -> float:
            return dim * math.log(orig / (rotations * 2 * math.pi)) / (2 * math.log(base))

        low = max(math.floor(correction_dim(rs.get("beta_fast") or 32)), 0)
        high = min(math.ceil(correction_dim(rs.get("beta_slow") or 1)), dim - 1)
        ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
                / (high - low if high != low else 0.001)).clamp(0, 1)
        extrapolation = 1 - ramp
        inv_freq = 1.0 / (factor * pos_freqs) * (1 - extrapolation) + inv_freq * extrapolation
        if rs.get("mscale") and rs.get("mscale_all_dim"):
            attention = yarn_mscale(factor, rs["mscale"]) / yarn_mscale(factor, rs["mscale_all_dim"])
    angles = torch.outer(torch.arange(s, dtype=torch.float32, device=device), inv_freq)
    return torch.cos(angles) * attention, torch.sin(angles) * attention


def rotate_pairs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x`` (..., s, d) rotated in f32 in its interleaved pairs (x[2i], x[2i+1])
    by the angles of (s, d / 2) ``cos`` / ``sin``, cast back."""
    pairs = x.float().unflatten(-1, (-1, 2))
    a, b = pairs[..., 0], pairs[..., 1]
    return torch.stack((a * cos - b * sin, a * sin + b * cos), dim=-1).flatten(-2).to(x.dtype)


class DeepseekV2Attention(nn.Module):
    """Latent attention (MLA), under the checkpoint's names."""

    def __init__(self, cfg: DeepseekV2Config):
        super().__init__()
        self.heads, self.nope, self.rope = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        self.v_dim, self.rank, self.scale = cfg.v_head_dim, cfg.kv_lora_rank, cfg.softmax_scale
        if cfg.q_lora_rank is None:
            self.q_proj = nn.Linear(cfg.hidden_size, self.heads * (self.nope + self.rope), bias=False)
        else:
            self.q_a_proj = nn.Linear(cfg.hidden_size, cfg.q_lora_rank, bias=cfg.attention_bias)
            self.q_a_layernorm = LlamaRMSNorm(cfg, cfg.q_lora_rank)
            self.q_b_proj = nn.Linear(cfg.q_lora_rank, self.heads * (self.nope + self.rope), bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(cfg.hidden_size, self.rank + self.rope, bias=cfg.attention_bias)
        self.kv_a_layernorm = LlamaRMSNorm(cfg, self.rank)
        self.kv_b_proj = nn.Linear(self.rank, self.heads * (self.nope + self.v_dim), bias=False)
        self.o_proj = nn.Linear(self.heads * self.v_dim, cfg.hidden_size, bias=cfg.attention_bias)

    def forward(self, x: torch.Tensor, bias: torch.Tensor | None, cos: torch.Tensor | None,
                sin: torch.Tensor | None) -> torch.Tensor:
        b, s, _ = x.shape
        h = self.heads
        q = (self.q_proj(x) if hasattr(self, "q_proj") else self.q_b_proj(self.q_a_layernorm(self.q_a_proj(x))))
        q = q.view(b, s, h, -1).transpose(1, 2)
        latent, k_pe = self.kv_a_proj_with_mqa(x).split([self.rank, self.rope], dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(latent)).view(b, s, h, -1).transpose(1, 2)
        k_nope, v = kv.split([self.nope, self.v_dim], dim=-1)
        if cos is None:
            k_pe = k_pe[:, None].expand(b, h, s, self.rope)
        else:
            q_nope, q_pe = q.split([self.nope, self.rope], dim=-1)
            q = torch.cat((q_nope, rotate_pairs(q_pe, cos, sin)), dim=-1)
            k_pe = rotate_pairs(k_pe[:, None], cos, sin).expand(b, h, s, self.rope)
        k = torch.cat((k_nope, k_pe), dim=-1)
        ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, is_causal=bias is None, scale=self.scale)
        return self.o_proj(ctx.transpose(1, 2).reshape(b, s, h * self.v_dim))


class MoEGate(nn.Module):
    def __init__(self, cfg: DeepseekV2Config):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cfg.n_routed_experts, cfg.hidden_size))
        if cfg.scoring_func == "sigmoid":
            self.e_score_correction_bias = nn.Parameter(torch.empty(cfg.n_routed_experts))


class GroupedExperts(nn.Module):
    """The held experts' SwiGLU weights stacked: ``gate_up`` (n, 2 x width,
    hidden), each expert's gate rows then its up rows, and ``down`` (n,
    hidden, width).  Loads from the checkpoint's per-expert names."""

    def __init__(self, cfg: DeepseekV2Config, held: tuple[int, int]):
        super().__init__()
        self.held, n, w = held, held[1] - held[0], cfg.moe_intermediate_size
        self.gate_up = nn.Parameter(torch.empty(n, 2 * w, cfg.hidden_size))
        self.down = nn.Parameter(torch.empty(n, cfg.hidden_size, w))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        names = [f"{prefix}{e}.{p}_proj.weight" for e in range(*self.held) for p in ("gate", "up", "down")]
        if all(n in state_dict for n in names):
            w = self.down.shape[-1]
            first = state_dict[names[0]]
            gate_up = torch.empty((len(names) // 3, 2 * w, first.shape[1]), dtype=first.dtype, device=first.device)
            down = torch.empty((len(names) // 3, first.shape[1], w), dtype=first.dtype, device=first.device)
            for j in range(len(names) // 3):
                gate_up[j, :w] = state_dict[names[3 * j]]
                gate_up[j, w:] = state_dict[names[3 * j + 1]]
                down[j] = state_dict[names[3 * j + 2]]
            state_dict[prefix + "gate_up"], state_dict[prefix + "down"] = gate_up, down
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class DeepseekV2MoE(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, layer: int, experts: tuple[int, int] | None = None):
        super().__init__()
        self.layer, self.layers = layer, cfg.num_hidden_layers
        self.top_k = cfg.num_experts_per_tok
        self.norm_topk, self.scaling = cfg.norm_topk_prob, cfg.routed_scaling_factor
        self.sigmoid = cfg.scoring_func == "sigmoid"
        self.groups, self.kept_groups = cfg.n_group or 1, cfg.topk_group or 1
        self.held = experts or (0, cfg.n_routed_experts)
        self.act = ACTIVATIONS[cfg.hidden_act]
        self.gate = MoEGate(cfg)
        self.experts = GroupedExperts(cfg, self.held)
        if cfg.n_shared_experts is not None:
            self.shared_experts = LlamaMLP(cfg, cfg.moe_intermediate_size * cfg.n_shared_experts)

    def route(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """For (t, hidden) ``x``: the (t, k) f32 weights of its pairs, the
        pair order sorted by held expert (pairs to other experts last), the
        held experts' int32 end offsets in that order, and the order's inverse
        (pair u * k + j's place in it), all made on the device."""
        logits = F.linear(x.float(), self.gate.weight.float())
        if self.sigmoid:
            scores = logits.sigmoid()
            choice = scores + self.gate.e_score_correction_bias.float()
            if self.groups > 1:
                grouped = choice.view(choice.shape[0], self.groups, -1)
                best = torch.topk(grouped.topk(2, dim=-1).values.sum(-1), self.kept_groups, dim=-1).indices
                dropped = torch.ones(grouped.shape[:2], dtype=torch.bool, device=x.device).scatter_(1, best, False)
                choice = grouped.masked_fill(dropped[..., None], float("-inf")).flatten(1)
            idx = torch.topk(choice, self.top_k, dim=-1).indices
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
        if profiling.active():
            held_counts = counts[:n]
            profiling.tally("moe.pairs", self.layer, held_counts, self.layers)
            profiling.tally("moe.pairs_max", self.layer, held_counts.max().reshape(1), self.layers)
            profiling.tally("moe.experts_used", self.layer, (held_counts > 0).sum().reshape(1), self.layers)
        inv = torch.empty_like(order).scatter_(0, order, torch.arange(order.numel(), device=x.device))
        return weights, order, torch.cumsum(counts[:n], 0, dtype=torch.int32), inv

    def routed(self, x: torch.Tensor, weights: torch.Tensor, order: torch.Tensor, offsets: torch.Tensor,
               inv: torch.Tensor, shared: torch.Tensor | None) -> torch.Tensor:
        """The held experts' weighted sum per token plus ``shared``, summed in
        f32 and rounded once to (t, hidden) in ``x``'s type (K4 on the card)."""
        k = weights.shape[1]
        rows = x[order // k]
        gate_up = torch._grouped_mm(rows, self.experts.gate_up.transpose(-2, -1), offs=offsets)
        gate, up = gate_up.chunk(2, dim=-1)
        out = torch._grouped_mm(self.act(gate) * up, self.experts.down.transpose(-2, -1), offs=offsets)
        with profiling.annotate("moe.combine", layer=self.layer, route="kernel" if out.is_cuda else "plain"):
            return moe_combine(out, inv, weights, offsets, shared)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(-1, x.shape[-1])
        shared = None
        if hasattr(self, "shared_experts"):
            with profiling.annotate("moe.shared", layer=self.layer):
                shared = self.shared_experts(flat)
        with profiling.annotate("moe.route", layer=self.layer):
            route = self.route(flat)
        with profiling.annotate("moe.experts", layer=self.layer):
            return self.routed(flat, *route, shared).view(x.shape)


class DeepseekV2DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, layer: int, experts: tuple[int, int] | None = None):
        super().__init__()
        self.layer = layer
        self.input_layernorm = LlamaRMSNorm(cfg)
        self.self_attn = DeepseekV2Attention(cfg)
        self.post_attention_layernorm = LlamaRMSNorm(cfg)
        self.mlp = DeepseekV2MoE(cfg, layer, experts) if cfg.is_moe(layer) else LlamaMLP(cfg)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        with profiling.annotate("mla.attn", layer=self.layer):
            x = x + self.self_attn(self.input_layernorm(x), bias, cos, sin)
        return x + self.mlp(self.post_attention_layernorm(x))


class DeepseekV2Model(nn.Module):
    """The decoder: ``forward`` gives the last hidden state (b, s, hidden)
    after ``norm``.  ``experts`` = (first, end) are the routed experts each
    MoE layer holds (all by default)."""

    base_model_prefix = "model"

    def __init__(self, cfg: DeepseekV2Config, experts: tuple[int, int] | None = None):
        super().__init__()
        self.config = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(DeepseekV2DecoderLayer(cfg, i, experts) for i in range(cfg.num_hidden_layers))
        self.norm = LlamaRMSNorm(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        s, dev = input_ids.shape[1], input_ids.device
        check_length(cfg, s)
        x = self.embed_tokens(input_ids)
        bias = decoder_bias(attention_mask, causal(s, dev), x.dtype)
        cos, sin = rope_table(cfg, s, dev)
        for layer in self.layers:
            x = layer(x, bias, cos, sin)
        return self.norm(x)
