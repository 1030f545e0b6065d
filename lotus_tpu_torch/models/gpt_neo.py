"""GPT-Neo as ``nn.Module``s, under Hugging Face's names (an RM only: the
Flax sequence-classification auto class does not map the type).

The forward is Flax GPT-Neo's
(``transformers/models/gpt_neo/modeling_flax_gpt_neo.py``): GPT-2's
skeleton (``gpt2.py``: ``wte`` + ``wpe`` at ``arange(seq)``, pre-LN blocks
``h.<i>``, ``ln_f``, the masks combined before they become one
``finfo.min`` bias) with ``nn.Linear`` projections and two quirks:

- the query is multiplied by sqrt(head size) before the attention divides
  it by the same (``:187``), so the scores are unscaled;
- each block's attention is ``attention_types`` expanded
  (``GPTNeoConfig.attention_layers``): a ``local`` block masks with
  ``causal ^ tril(causal, -window_size)`` (``:138-139``), so query i sees
  keys i - window_size + 1 .. i; a ``global`` one is causal.

q, k and v have no bias (``attn.attention.q_proj`` ...), ``out_proj`` has
one; the MLP is ``c_fc``, ``activation_function``, ``c_proj``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar

import torch
from torch import nn

from lotus_tpu_torch.models.bert import ACTIVATIONS, BertSelfAttention, EncoderConfig
from lotus_tpu_torch.models.gpt2 import GPT2Model, causal, decoder_bias, split_heads


@dataclass(frozen=True)
class GPTNeoConfig(EncoderConfig):
    """The fields of a GPT-Neo ``config.json`` the forward reads (the
    defaults are ``transformers``' ``GPTNeoConfig``'s)."""

    model_types: ClassVar[tuple[str, ...]] = ("gpt_neo",)
    activation_key: ClassVar[str] = "activation_function"

    vocab_size: int = 50257
    max_position_embeddings: int = 2048
    hidden_size: int = 2048
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int | None = None
    window_size: int = 256
    attention_types: tuple = ((("global", "local"), 12),)
    activation_function: str = "gelu_new"
    layer_norm_epsilon: float = 1e-5
    num_labels: int = 2

    @property
    def attention_layers(self) -> list[str]:
        """Each layer's attention type, ``attention_types`` expanded: each
        ``[types, n]`` repeats ``types`` n times."""
        layers = [t for types, n in self.attention_types for _ in range(n) for t in types]
        if len(layers) != self.num_layers:
            raise ValueError(f"attention_types {self.attention_types!r} give {len(layers)} layers, the config has "
                             f"num_layers {self.num_layers}")
        return layers


class GPTNeoSelfAttention(nn.Module):
    def __init__(self, cfg: GPTNeoConfig):
        super().__init__()
        self.heads = cfg.num_heads
        width = cfg.hidden_size
        self.q_proj, self.k_proj, self.v_proj = (nn.Linear(width, width, bias=False) for _ in range(3))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        q = self.q_proj(x) * math.sqrt(x.shape[-1] // self.heads)  # undone by attend's 1/sqrt: unscaled scores
        q, k, v = (split_heads(t, self.heads) for t in (q, self.k_proj(x), self.v_proj(x)))
        return self.out_proj(BertSelfAttention.merge(BertSelfAttention.attend(q, k, v, bias)))


class GPTNeoAttention(nn.Module):
    def __init__(self, cfg: GPTNeoConfig):
        super().__init__()
        self.attention = GPTNeoSelfAttention(cfg)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return self.attention(x, bias)


class GPTNeoMLP(nn.Module):
    def __init__(self, cfg: GPTNeoConfig):
        super().__init__()
        inner = cfg.intermediate_size or 4 * cfg.hidden_size
        self.c_fc = nn.Linear(cfg.hidden_size, inner)
        self.c_proj = nn.Linear(inner, cfg.hidden_size)
        self.act = ACTIVATIONS[cfg.activation_function]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(self.act(self.c_fc(x)))


class GPTNeoBlock(nn.Module):
    def __init__(self, cfg: GPTNeoConfig):
        super().__init__()
        self.ln_1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_epsilon)
        self.attn = GPTNeoAttention(cfg)
        self.ln_2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_epsilon)
        self.mlp = GPTNeoMLP(cfg)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), bias)
        return x + self.mlp(self.ln_2(x))


class GPTNeoModel(GPT2Model):
    """The decoder: ``forward`` gives the last hidden state (b, s,
    hidden_size) after ``ln_f``."""

    block_cls = GPTNeoBlock

    @property
    def num_blocks(self) -> int:
        return self.config.num_layers

    def block_biases(self, attention_mask: torch.Tensor, dtype: torch.dtype) -> list[torch.Tensor]:
        """A banded bias for the local blocks, a causal one for the others."""
        full = causal(attention_mask.shape[1], attention_mask.device)
        allowed = {False: full, True: full ^ full.tril(-self.config.window_size)}
        local = [kind == "local" for kind in self.config.attention_layers]
        biases = {is_local: decoder_bias(attention_mask, allowed[is_local], dtype) for is_local in set(local)}
        return [biases[is_local] for is_local in local]
