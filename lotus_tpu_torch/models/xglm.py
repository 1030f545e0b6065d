"""XGLM as ``nn.Module``s, under Hugging Face's names (an RM only: the Flax
sequence-classification auto class does not map the type).

The forward is Flax XGLM's (``transformers/models/xglm/modeling_flax_xglm.py``):

- token embeddings ``embed_tokens`` times ``embed_scale`` (sqrt(d_model)
  under ``scale_embedding``), plus sinusoidal positions at ``arange(seq) +
  2`` whatever the padding (``:475-502``, ``:639-641``).  The table is
  Flax's ``create_sinusoidal_positions`` (``:112-123``): frequencies
  ``exp(-j * log(10000) / (half - 1))``, sin then cos, row 1 zeroed, made
  in numpy and held in f32; it is computed here, and position weights a
  file may carry are not read.  Under a bf16 model the f32 positions make
  the residual stream f32, as in the reference: each LayerNorm takes its
  statistics of the f32 stream and gives the module's dtype, and each
  residual sum is f32 again;
- per layer (``layers.<i>``, pre-LN): ``self_attn_layer_norm``, attention
  (``self_attn.{q,k,v}_proj`` with biases, the query scaled by 1/sqrt(head
  size), the causal and attention masks combined before one
  ``finfo(dtype).min`` bias, ``gpt2.decoder_bias``; scores and softmax in
  the module's dtype), ``self_attn.out_proj``, the residual;
  ``final_layer_norm``, ``fc1``, ``activation_function``
  (``bert.ACTIVATIONS``), ``fc2``, the residual; a final ``layer_norm``.
  Every LayerNorm's epsilon is 1e-5.

The causal mask is built at ``max_position_embeddings`` (``:157-160``), so
a longer bucket fails the reference; the port raises ``ValueError`` before
it runs (``bart.check_length``).  Plain ``nn.Linear``, ``torch.matmul``
and ``softmax``: no fused attention.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lotus_tpu_torch.models.bart import check_length
from lotus_tpu_torch.models.bert import ACTIVATIONS, BertSelfAttention, EncoderConfig
from lotus_tpu_torch.models.gpt2 import causal, decoder_bias, split_heads

POSITION_OFFSET = 2  # position_ids + 2 (FlaxXGLMModule.offset)


@dataclass(frozen=True)
class XGLMConfig(EncoderConfig):
    """The fields of an XGLM ``config.json`` the forward reads (the defaults
    are ``transformers``' ``XGLMConfig``'s, xglm-564M's), also under the
    names of its ``attribute_map``."""

    model_types: ClassVar[tuple[str, ...]] = ("xglm",)
    activation_key: ClassVar[str] = "activation_function"
    aliases: ClassVar[dict[str, str]] = {"num_attention_heads": "attention_heads", "hidden_size": "d_model",
                                         "num_hidden_layers": "num_layers"}

    vocab_size: int = 256008
    max_position_embeddings: int = 2048
    d_model: int = 1024
    ffn_dim: int = 4096
    num_layers: int = 24
    attention_heads: int = 16
    activation_function: str = "gelu"
    scale_embedding: bool = True
    num_labels: int = 2

    @property
    def hidden_size(self) -> int:
        return self.d_model


def sinusoidal_positions(s: int, dim: int) -> torch.Tensor:
    """(s, dim) f32: rows ``POSITION_OFFSET .. s + 1`` of Flax's
    ``create_sinusoidal_positions(max_position_embeddings + 2, dim)`` (row
    1, the one it zeroes, is never taken)."""
    half = dim // 2
    freq = np.exp(np.arange(half) * -(math.log(10000) / (half - 1)))
    angles = np.arange(POSITION_OFFSET, POSITION_OFFSET + s)[:, None] * freq[None]
    return torch.from_numpy(np.concatenate([np.sin(angles), np.cos(angles)], 1).reshape(s, dim).astype(np.float32))


class XGLMLayerNorm(nn.LayerNorm):
    """Flax's LayerNorm under a module dtype: statistics and the affine map
    in f32 of whatever the input is, the output in the parameters' dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(), self.bias.float(), self.eps)
        return out.to(self.weight.dtype)


class XGLMAttention(nn.Module):
    def __init__(self, cfg: XGLMConfig):
        super().__init__()
        self.heads = cfg.attention_heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(cfg.d_model, cfg.d_model) for _ in range(4))

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        q, k, v = (split_heads(p(x), self.heads) for p in (self.q_proj, self.k_proj, self.v_proj))
        return self.out_proj(BertSelfAttention.merge(BertSelfAttention.attend(q, k, v, bias)))


class XGLMDecoderLayer(nn.Module):
    def __init__(self, cfg: XGLMConfig):
        super().__init__()
        self.self_attn = XGLMAttention(cfg)
        self.self_attn_layer_norm = XGLMLayerNorm(cfg.d_model, eps=1e-5)
        self.fc1 = nn.Linear(cfg.d_model, cfg.ffn_dim)
        self.fc2 = nn.Linear(cfg.ffn_dim, cfg.d_model)
        self.final_layer_norm = XGLMLayerNorm(cfg.d_model, eps=1e-5)
        self.act = ACTIVATIONS[cfg.activation_function]

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.self_attn_layer_norm(x), bias)
        return x + self.fc2(self.act(self.fc1(self.final_layer_norm(x))))


class XGLMModel(nn.Module):
    """The decoder: ``forward`` gives the last hidden state (b, s, d_model)
    after ``layer_norm``, in the parameters' dtype."""

    base_model_prefix = "model"

    def __init__(self, cfg: XGLMConfig):
        super().__init__()
        self.config = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.layers = nn.ModuleList(XGLMDecoderLayer(cfg) for _ in range(cfg.num_layers))
        self.layer_norm = XGLMLayerNorm(cfg.d_model, eps=1e-5)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        s, dev = input_ids.shape[1], input_ids.device
        check_length(cfg, s)
        embeds = self.embed_tokens(input_ids)
        if cfg.scale_embedding:
            embeds = embeds * math.sqrt(cfg.d_model)
        x = embeds + sinusoidal_positions(s, cfg.d_model).to(dev)  # f32 whatever the model's dtype
        bias = decoder_bias(attention_mask, causal(s, dev), embeds.dtype)
        for layer in self.layers:
            x = layer(x, bias)
        return self.layer_norm(x)
