"""Kimi-Linear as ``nn.Module``s (an RM only), under the published modeling
code's names (``modeling_kimi.py`` of ``moonshotai/Kimi-Linear-48B-A3B-Instruct``;
its KDA layer is ``fla``'s ``KimiDeltaAttention``):

- token embeddings ``embed_tokens`` and no position embedding anywhere; per
  layer RMSNorm (``input_layernorm``), the layer's attention, residual,
  RMSNorm (``post_attention_layernorm``), the MLP, residual; a final
  ``norm``;
- the attention is KDA in the layers ``linear_attn_config["kda_layers"]``
  lists and latent attention (``deepseek_v2.DeepseekV2Attention``, MLA
  without a query LoRA) in its ``full_attn_layers``, both 1-based and
  together every layer; with ``mla_use_nope`` MLA rotates nothing and scores
  causally at (nope + rope)^-0.5;
- KDA (``KimiDeltaAttention``): ``q_proj``, ``k_proj``, ``v_proj`` (hidden ->
  heads x head_dim), each through its depthwise causal convolution of
  ``short_conv_kernel_size`` taps without bias (``q_conv1d``, ``k_conv1d``,
  ``v_conv1d``), then SiLU; q and k L2-normalised per head (eps 1e-6 under
  the root); the decay per key channel in f32, ``-exp(A_log[h]) *
  softplus(f_b_proj(f_a_proj(x)) + dt_bias)``; ``beta = sigmoid(b_proj(x))``
  in f32; the recurrence (``ops/kda.py``, its state in f32); the output
  RMSNorm per head (``o_norm``) times ``sigmoid(g_b_proj(g_a_proj(x)))``,
  then ``o_proj``;
- the MLP is dense SwiGLU in the first ``first_k_dense_replace`` layers,
  else ``deepseek_v2.DeepseekV2MoE`` over ``num_experts`` with sigmoid
  scores and ``e_score_correction_bias`` (``noaux_tc`` in one group,
  renormalised under ``moe_renormalize``, times ``routed_scaling_factor``)
  and ``num_shared_experts`` shared.

Names this port could not confirm against the published code and took from
DeepSeek-V2's or ``fla``'s instead: the routed experts'
``mlp.experts.<e>.{gate,up,down}_proj`` and the shared experts'
``mlp.shared_experts`` (the remote code may name the block
``block_sparse_moe`` and the projections ``w1`` / ``w3`` / ``w2``), the
gate's ``mlp.gate.weight`` and ``e_score_correction_bias``, no bias in
``g_b_proj``, and ``o_norm.weight`` of ``head_dim`` shared by the heads.
``A_log`` loads from any shape of ``num_heads`` entries (the remote code
may keep it as (1, 1, heads, 1)).

The model reads no attention mask: a row's pads must come after its real
tokens (right padding, as this family's tokenizer files pad), which the
causal attention and the recurrence never let reach them.  The forward
makes no host synchronisation.  Spans (``lotus_tpu_torch.profiling``):
``kda.attn`` (a KDA layer, its norm included) over ``kda.scan`` (the
recurrence alone, K6 on the card; attribute ``route``, ``kernel`` on the card
and ``plain`` on the CPU), ``mla.attn`` and the MoE
layer's; the counter ``kda.tokens`` holds the (token, head) pairs each
layer's scan ran over, padding included.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch
import torch.nn.functional as F
from torch import nn

from lotus_tpu_torch import profiling
from lotus_tpu_torch.models.deepseek_v2 import DeepseekV2Attention, DeepseekV2Config, DeepseekV2MoE
from lotus_tpu_torch.models.llama import LlamaMLP, LlamaRMSNorm
from lotus_tpu_torch.ops import kda

L2_EPS = 1e-6


@dataclass(frozen=True, eq=False)
class KimiLinearConfig(DeepseekV2Config):
    """The fields of a Kimi-Linear ``config.json`` the forward reads, under
    DeepSeek-V2's names where the two share a module (``aliases``)."""

    model_types: ClassVar[tuple[str, ...]] = ("kimi_linear",)
    aliases: ClassVar[dict[str, str]] = {
        "num_experts": "n_routed_experts", "num_experts_per_token": "num_experts_per_tok",
        "num_shared_experts": "n_shared_experts", "moe_renormalize": "norm_topk_prob",
        "moe_router_activation_func": "scoring_func", "num_expert_group": "n_group",
    }

    linear_attn_config: dict | None = None
    mla_use_nope: bool = False
    rms_norm_eps: float = 1e-5

    @classmethod
    def from_dict(cls, cfg: dict):
        """Sigmoid scores choose through the correction bias (``noaux_tc``);
        softmax scores run greedy."""
        sigmoid = cfg.get("moe_router_activation_func", cfg.get("scoring_func")) == "sigmoid"
        return super().from_dict({**cfg, "topk_method": "noaux_tc" if sigmoid else "greedy"})

    def __post_init__(self) -> None:
        super().__post_init__()
        if max(self.n_group or 1, self.topk_group or 1) > 1:
            raise NotImplementedError(f"num_expert_group {self.n_group} / topk_group {self.topk_group}: the port runs "
                                      f"Kimi-Linear's router over one group")
        if not self.mla_use_nope or self.rope_scaling is not None:
            raise NotImplementedError("the port runs Kimi-Linear's latent attention without positions "
                                      "(mla_use_nope, no rope_scaling)")
        lac = self.linear_attn_config or {}
        kda, full = lac.get("kda_layers", []), lac.get("full_attn_layers", [])
        if sorted([*kda, *full]) != list(range(1, self.num_hidden_layers + 1)):
            raise ValueError(f"linear_attn_config's kda_layers {kda} and full_attn_layers {full} must number "
                             f"the {self.num_hidden_layers} layers from 1, each once")

    def is_kda(self, layer: int) -> bool:
        """Whether 0-based ``layer`` is a KDA layer (the config counts from 1)."""
        return layer + 1 in self.linear_attn_config["kda_layers"]


def causal_conv(y: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution of channels-first (b, c, s) ``y`` by (c,
    1, taps) ``weight`` (``nn.Conv1d``'s, no bias): (b, c, s + taps - 1), of
    which column t < s is sum_j w[j] y[t - taps + 1 + j]."""
    return F.conv1d(y, weight, padding=weight.shape[-1] - 1, groups=y.shape[1])


def l2norm_(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` divided in place by sqrt(sum x^2 + 1e-6) over ``dim``."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x.mul_(torch.rsqrt(norm.square_().add_(L2_EPS)))


class ShortConvolution(nn.Module):
    """The depthwise causal convolution's taps, ``weight`` (channels, 1, taps)."""

    def __init__(self, channels: int, taps: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, 1, taps))


class FusedRMSNormGated(nn.Module):
    """RMSNorm of each head's output over its channels, times ``weight``
    (shared by the heads) and the sigmoid of the gate, in f32."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
        """``x`` (f32, normalised in place) and ``gate`` (..., heads, dim)."""
        rms = torch.linalg.vector_norm(x, dim=-1, keepdim=True).square_().div_(x.shape[-1]).add_(self.eps)
        return x.mul_(rms.rsqrt_()).mul_(self.weight.float()).mul_(torch.sigmoid(gate.float()))


class KimiDeltaAttention(nn.Module):
    """One KDA layer, (b, s, hidden) -> (b, s, hidden)."""

    def __init__(self, cfg: KimiLinearConfig, layer: int):
        super().__init__()
        lac = cfg.linear_attn_config
        self.layer, self.layers = layer, cfg.num_hidden_layers
        self.heads, self.head_dim = lac["num_heads"], lac["head_dim"]
        hidden, width, taps = cfg.hidden_size, self.heads * self.head_dim, lac["short_conv_kernel_size"]
        self.q_proj = nn.Linear(hidden, width, bias=False)
        self.k_proj = nn.Linear(hidden, width, bias=False)
        self.v_proj = nn.Linear(hidden, width, bias=False)
        self.q_conv1d = ShortConvolution(width, taps)
        self.k_conv1d = ShortConvolution(width, taps)
        self.v_conv1d = ShortConvolution(width, taps)
        self.A_log = nn.Parameter(torch.empty(self.heads))
        self.f_a_proj = nn.Linear(hidden, self.head_dim, bias=False)
        self.f_b_proj = nn.Linear(self.head_dim, width, bias=False)
        self.dt_bias = nn.Parameter(torch.empty(width))
        self.b_proj = nn.Linear(hidden, self.heads, bias=False)
        self.g_a_proj = nn.Linear(hidden, self.head_dim, bias=False)
        self.g_b_proj = nn.Linear(self.head_dim, width, bias=False)
        self.o_norm = FusedRMSNormGated(self.head_dim, cfg.rms_norm_eps)
        self.o_proj = nn.Linear(width, hidden, bias=False)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        if prefix + "A_log" in state_dict:
            state_dict[prefix + "A_log"] = state_dict[prefix + "A_log"].reshape(-1)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def _branch(self, proj: nn.Linear, conv: ShortConvolution, xt: torch.Tensor, s: int) -> torch.Tensor:
        """SiLU of the causal convolution of a projection, in chunk tiles
        (``kda.from_channels``); the projection is made channels first."""
        return F.silu(kda.from_channels(causal_conv(proj.weight @ xt, conv.weight), s, self.heads), inplace=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        h, d = self.heads, self.head_dim
        xt = x.mT
        q = l2norm_(self._branch(self.q_proj, self.q_conv1d, xt, s), dim=-2)
        k = l2norm_(self._branch(self.k_proj, self.k_conv1d, xt, s), dim=-2)
        v = self._branch(self.v_proj, self.v_conv1d, xt, s)
        f = kda.from_channels(self.f_b_proj.weight @ self.f_a_proj(x).mT, s, h)  # (chunks, b x h, d, C)
        f = f.unflatten(1, (b, h)).add_(self.dt_bias.float().view(h, d, 1))
        g = F.softplus(f).mul_(-torch.exp(self.A_log.float()).view(h, 1, 1)).flatten(1, 2)
        beta = kda.from_channels(torch.sigmoid((self.b_proj.weight @ xt).float()), s, h)
        with profiling.annotate("kda.scan", layer=self.layer, route="kernel" if q.is_cuda else "plain"):
            o = kda.scan_chunks(q, k, v, g, beta)
        if profiling.active():
            profiling.tally("kda.tokens", self.layer, torch.full((1,), b * s * h, dtype=torch.int64, device=x.device),
                            self.layers)
        o = self.o_norm(kda.to_rows(o, b, s), self.g_b_proj(self.g_a_proj(x)).view(b, s, h, d))
        return self.o_proj(o.to(x.dtype).reshape(b, s, h * d))


class KimiDecoderLayer(nn.Module):
    def __init__(self, cfg: KimiLinearConfig, layer: int, experts: tuple[int, int] | None = None):
        super().__init__()
        self.layer, self.kda = layer, cfg.is_kda(layer)
        self.input_layernorm = LlamaRMSNorm(cfg)
        self.self_attn = KimiDeltaAttention(cfg, layer) if self.kda else DeepseekV2Attention(cfg)
        self.post_attention_layernorm = LlamaRMSNorm(cfg)
        self.mlp = DeepseekV2MoE(cfg, layer, experts) if cfg.is_moe(layer) else LlamaMLP(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kda:
            with profiling.annotate("kda.attn", layer=self.layer):
                x = x + self.self_attn(self.input_layernorm(x))
        else:
            with profiling.annotate("mla.attn", layer=self.layer):
                x = x + self.self_attn(self.input_layernorm(x), None, None, None)
        return x + self.mlp(self.post_attention_layernorm(x))


class KimiLinearModel(nn.Module):
    """The decoder: ``forward`` gives the last hidden state (b, s, hidden)
    after ``norm``.  ``experts`` = (first, end) are the routed experts each
    MoE layer holds (all by default); each routes over ``num_experts``."""

    base_model_prefix = "model"

    def __init__(self, cfg: KimiLinearConfig, experts: tuple[int, int] | None = None):
        super().__init__()
        self.config = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(KimiDecoderLayer(cfg, i, experts) for i in range(cfg.num_hidden_layers))
        self.norm = LlamaRMSNorm(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x)
        return self.norm(x)
