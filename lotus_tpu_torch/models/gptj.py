"""GPT-J as ``nn.Module``s, under Hugging Face's names (an RM only: the Flax
sequence-classification auto class does not map the type).

The forward is Flax GPT-J's (``transformers/models/gptj/modeling_flax_gptj.py``):

- token embeddings ``wte`` only: positions enter through rotary
  embeddings at ``arange(seq)``, whatever the padding;
- each block (``h.<i>``) runs the attention and the MLP in parallel off one
  LayerNorm: ``attn(ln_1(x)) + mlp(ln_1(x)) + x``, summed in that order
  (``:341-353``); a final ``ln_f``;
- rotary on the first ``rotary_dim`` dims of each head's query and key
  only, with interleaved pairs (``rotate_every_two``, ``:122-132``, ``:225``):
  the table's sin and cos of ``arange(seq) * 10000^(-2j / rotary_dim)``
  (``create_sinusoidal_positions``, ``:108-117``, in numpy as Flax makes
  it), each repeated twice along the dims;
- q, k, v and ``out_proj`` without bias, the query scaled by 1/sqrt(head
  size), the causal and attention masks combined into one ``finfo.min``
  bias (``gpt2.decoder_bias``); the MLP ``fc_in``, ``activation_function``,
  ``fc_out``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import numpy as np
import torch
from torch import nn

from lotus_tpu_torch.models.bart import check_length
from lotus_tpu_torch.models.bert import ACTIVATIONS, BertSelfAttention, EncoderConfig
from lotus_tpu_torch.models.gpt2 import causal, decoder_bias, split_heads


@dataclass(frozen=True)
class GPTJConfig(EncoderConfig):
    """The fields of a GPT-J ``config.json`` the forward reads (the defaults
    are ``transformers``' ``GPTJConfig``'s)."""

    model_types: ClassVar[tuple[str, ...]] = ("gptj",)
    activation_key: ClassVar[str] = "activation_function"

    vocab_size: int = 50400
    n_positions: int = 2048
    n_embd: int = 4096
    n_layer: int = 28
    n_head: int = 16
    rotary_dim: int | None = 64
    n_inner: int | None = None
    activation_function: str = "gelu_new"
    layer_norm_epsilon: float = 1e-5
    num_labels: int = 2

    @property
    def hidden_size(self) -> int:
        return self.n_embd

    @property
    def max_position_embeddings(self) -> int:
        return self.n_positions


def rotary_table(s: int, dim: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos), each (s, dim) f32 with each frequency's column twice in
    a row: Flax GPT-J's table for positions 0 .. s-1, made as it makes it."""
    inv_freq = 1.0 / (10000 ** (np.arange(0, dim, 2) / dim))
    angles = np.einsum("i , j -> i j", np.arange(s), inv_freq).astype("float32")
    return tuple(torch.from_numpy(f(angles)).to(device).repeat_interleave(2, dim=-1) for f in (np.sin, np.cos))


def rotate_every_two(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...)."""
    return torch.stack((-x[..., 1::2], x[..., ::2]), dim=-1).flatten(-2)


class GPTJAttention(nn.Module):
    def __init__(self, cfg: GPTJConfig):
        super().__init__()
        self.heads = cfg.n_head
        self.rotary_dim = cfg.rotary_dim or cfg.n_embd
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(cfg.n_embd, cfg.n_embd, bias=False)
                                                                for _ in range(4))

    def rotate(self, t: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
        """Rotary on the first ``rotary_dim`` dims of (b, heads, s, d)."""
        r = self.rotary_dim
        rot = t[..., :r] * cos + rotate_every_two(t[..., :r]) * sin
        return torch.cat([rot, t[..., r:]], dim=-1).to(t.dtype)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
        q, k, v = (split_heads(p(x), self.heads) for p in (self.q_proj, self.k_proj, self.v_proj))
        ctx = BertSelfAttention.attend(self.rotate(q, sin, cos), self.rotate(k, sin, cos), v, bias)
        return self.out_proj(BertSelfAttention.merge(ctx))


class GPTJMLP(nn.Module):
    def __init__(self, cfg: GPTJConfig):
        super().__init__()
        inner = cfg.n_inner or 4 * cfg.n_embd
        self.fc_in = nn.Linear(cfg.n_embd, inner)
        self.fc_out = nn.Linear(inner, cfg.n_embd)
        self.act = ACTIVATIONS[cfg.activation_function]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc_out(self.act(self.fc_in(x)))


class GPTJBlock(nn.Module):
    def __init__(self, cfg: GPTJConfig):
        super().__init__()
        self.ln_1 = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon)
        self.attn = GPTJAttention(cfg)
        self.mlp = GPTJMLP(cfg)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
        h = self.ln_1(x)
        return self.attn(h, bias, sin, cos) + self.mlp(h) + x


class GPTJModel(nn.Module):
    """The decoder: ``forward`` gives the last hidden state (b, s, n_embd)
    after ``ln_f``."""

    base_model_prefix = "transformer"

    def __init__(self, cfg: GPTJConfig):
        super().__init__()
        self.config = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.n_embd)
        self.h = nn.ModuleList(GPTJBlock(cfg) for _ in range(cfg.n_layer))
        self.ln_f = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        s, dev = input_ids.shape[1], input_ids.device
        check_length(self.config, s)
        x = self.wte(input_ids)
        bias = decoder_bias(attention_mask, causal(s, dev), x.dtype)
        sin, cos = rotary_table(s, self.config.rotary_dim or self.config.n_embd, dev)
        for block in self.h:
            x = block(x, bias, sin, cos)
        return self.ln_f(x)
