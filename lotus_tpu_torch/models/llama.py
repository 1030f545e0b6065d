"""Llama as ``nn.Module``s, under Hugging Face's names (an RM only: the Flax
sequence-classification auto class does not map the type), and the skeleton
Mistral (``mistral.py``) and Gemma (``gemma.py``) run under their own
layouts.

The forward is Flax Llama's (``transformers/models/llama/modeling_flax_llama.py``):

- token embeddings ``embed_tokens``; positions enter only through rotary
  embeddings at ``arange(seq)`` (``:456-457``), whatever the padding, so a
  left-padded row's tokens sit at shifted positions;
- per layer RMSNorm (``input_layernorm``), attention, residual, RMSNorm
  (``post_attention_layernorm``), SwiGLU MLP
  (``down_proj(up_proj(x) * silu(gate_proj(x)))``), residual; a final
  ``norm``.  RMSNorm takes the mean square in f32, divides by
  sqrt(ms + eps), casts back and scales by ``weight`` (``:161-168``);
- rotary at base 10000 whatever ``rope_theta`` or ``rope_scaling`` say
  (``create_sinusoidal_positions`` hard-codes it, ``:131-137``): the table
  ``[sin(a), sin(a)][cos(a), cos(a)]`` of ``a = arange * 10000^(-2j / d)``,
  its columns cut at ``max_position_embeddings`` as Flax cuts them, made in
  numpy as Flax makes it; ``x * cos + rotate_half(x) * sin`` on query and
  key, then cast back to the hidden dtype;
- grouped KV heads: each of ``num_key_value_heads`` repeated to the query
  heads (``jnp.repeat``, ``:304-305``); the query scaled by 1/sqrt(head
  size); below f32 the scores and softmax run in f32
  (``attention_softmax_in_fp32``); the causal and attention masks combined
  into one ``finfo.min`` bias (``gpt2.decoder_bias``), built at the bucket
  length (Flax builds it at ``max_position_embeddings`` and cuts it: the
  same values, without Mistral's 32768² mask);
- ``attention_bias`` gives q, k, v and o a bias.

A family's layout is its config's: ``allowed`` (the mask band: causal here,
Mistral's sliding window), ``head_size``, ``qkv_bias``, and the class
variables ``norm_offset`` (Gemma's RMSNorm scales by 1 + weight) and
``embedding_scale`` (Gemma multiplies the embeddings by sqrt(hidden)).
A bucket past ``max_position_embeddings`` raises ``ValueError``, as the
reference fails there (``bart.check_length``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar

import numpy as np
import torch
from torch import nn

from lotus_tpu_torch.models.bart import check_length
from lotus_tpu_torch.models.bert import ACTIVATIONS, BertSelfAttention, EncoderConfig
from lotus_tpu_torch.models.gpt2 import causal, decoder_bias, split_heads


@dataclass(frozen=True)
class LlamaConfig(EncoderConfig):
    """The fields of a Llama ``config.json`` the forward reads (the defaults
    are ``transformers``' ``LlamaConfig``'s; ``rope_theta`` and
    ``rope_scaling`` are not read, as Flax does not read them)."""

    model_types: ClassVar[tuple[str, ...]] = ("llama",)
    norm_offset: ClassVar[float] = 0.0
    embedding_scale: ClassVar[bool] = False

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int | None = None
    hidden_act: str = "silu"
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    attention_bias: bool = False
    num_labels: int = 2

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    @property
    def qkv_bias(self) -> bool:
        return self.attention_bias

    def allowed(self, s: int, device: torch.device) -> torch.Tensor:
        """(s, s) bool: the keys each query may see (causal)."""
        return causal(s, device)


def rotary_table(cfg: LlamaConfig, s: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos), each (s, head size) f32: rows 0 .. s-1 of Flax's
    ``create_sinusoidal_positions(max_position_embeddings, head size)``."""
    dim = cfg.head_size
    inv_freq = 1.0 / (10000 ** (np.arange(0, dim, 2)[: dim // 2] / dim))
    freqs = np.einsum("i , j -> i j", np.arange(s), inv_freq).astype("float32")
    emb = np.concatenate((freqs, freqs), axis=-1)
    out = np.concatenate((np.sin(emb), np.cos(emb)), axis=-1)[:, : cfg.max_position_embeddings]
    sin, cos = np.split(out, 2, axis=-1)
    return torch.from_numpy(sin).to(device), torch.from_numpy(cos).to(device)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat((-x[..., half:], x[..., :half]), dim=-1)


class LlamaRMSNorm(nn.Module):
    """RMSNorm over the hidden size, or over ``size`` (DeepSeek-V2's latent)."""

    def __init__(self, cfg: LlamaConfig, size: int | None = None):
        super().__init__()
        self.eps = cfg.rms_norm_eps
        self.offset = getattr(cfg, "norm_offset", 0.0)
        self.weight = nn.Parameter(torch.empty(size or cfg.hidden_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        variance = x.float().pow(2).mean(-1, keepdim=True)
        normed = (x / torch.sqrt(variance + self.eps)).to(x.dtype)
        return (self.offset + self.weight if self.offset else self.weight) * normed


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.heads, self.kv_heads, d = cfg.num_attention_heads, cfg.kv_heads, cfg.head_size
        bias = cfg.qkv_bias
        self.q_proj = nn.Linear(cfg.hidden_size, self.heads * d, bias=bias)
        self.k_proj = nn.Linear(cfg.hidden_size, self.kv_heads * d, bias=bias)
        self.v_proj = nn.Linear(cfg.hidden_size, self.kv_heads * d, bias=bias)
        self.o_proj = nn.Linear(self.heads * d, cfg.hidden_size, bias=bias)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
        q = split_heads(self.q_proj(x), self.heads)
        k = split_heads(self.k_proj(x), self.kv_heads)
        v = split_heads(self.v_proj(x), self.kv_heads)
        q, k = ((t * cos + rotate_half(t) * sin).to(x.dtype) for t in (q, k))
        groups = self.heads // self.kv_heads
        if groups > 1:
            k, v = k.repeat_interleave(groups, dim=1), v.repeat_interleave(groups, dim=1)
        if x.dtype == torch.float32:
            ctx = BertSelfAttention.attend(q, k, v, bias)
        else:  # attention_softmax_in_fp32: the scores and softmax in f32
            scores = torch.matmul(q.float() / math.sqrt(q.shape[-1]), k.float().transpose(-1, -2)) + bias.float()
            ctx = torch.matmul(torch.softmax(scores, dim=-1).to(x.dtype), v)
        return self.o_proj(BertSelfAttention.merge(ctx))


class LlamaMLP(nn.Module):
    """The SwiGLU MLP, ``intermediate_size`` wide or ``width`` (DeepSeek-V2's
    shared experts)."""

    def __init__(self, cfg: LlamaConfig, width: int | None = None):
        super().__init__()
        width = width or cfg.intermediate_size
        self.gate_proj = nn.Linear(cfg.hidden_size, width, bias=False)
        self.up_proj = nn.Linear(cfg.hidden_size, width, bias=False)
        self.down_proj = nn.Linear(width, cfg.hidden_size, bias=False)
        self.act = ACTIVATIONS[getattr(cfg, cfg.activation_key)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(self.up_proj(x) * self.act(self.gate_proj(x)))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.input_layernorm = LlamaRMSNorm(cfg)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = LlamaRMSNorm(cfg)
        self.mlp = LlamaMLP(cfg)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.input_layernorm(x), bias, sin, cos)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    """The decoder: ``forward`` gives the last hidden state (b, s, hidden)
    after ``norm``."""

    base_model_prefix = "model"

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.config = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(LlamaDecoderLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.norm = LlamaRMSNorm(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        s, dev = input_ids.shape[1], input_ids.device
        check_length(cfg, s)
        x = self.embed_tokens(input_ids)
        if cfg.embedding_scale:
            x = x * cfg.hidden_size**0.5
        bias = decoder_bias(attention_mask, cfg.allowed(s, dev), x.dtype)
        sin, cos = rotary_table(cfg, s, dev)
        for layer in self.layers:
            x = layer(x, bias, sin, cos)
        return self.norm(x)

