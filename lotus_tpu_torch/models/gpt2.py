"""GPT-2 as ``nn.Module``s, under Hugging Face's names (an RM only: the Flax
sequence-classification auto class does not map the type), and what the
port's decoder-only models share (``decoder_bias``, ``causal``).

The forward is Flax GPT-2's (``transformers/models/gpt2/modeling_flax_gpt2.py``),
which ``JaxSentenceEncoderRM`` runs as XLA when called with ids and mask
only:

- token embeddings ``wte`` plus learned positions ``wpe`` at
  ``arange(seq)`` (``:484-488``, ``:623-626``), whatever the padding;
- per block (``h.<i>``) the LayerNorm before the attention and before the
  MLP (``ln_1``, ``ln_2``), the residual after each; a final ``ln_f``;
- ``Conv1D`` projections: ``x @ weight + bias`` with ``weight`` (in, out),
  as torch files store them; Flax's kernel is (out, in) and transposed in
  the forward (``:110-120``), so ``checkpoint.flax_state_dict``'s
  transpose of every ``kernel`` gives torch's layout;
- ``c_attn`` gives q, k and v side by side; the query is scaled by
  1/sqrt(head size) before the product; the causal mask (built at
  ``n_positions`` and cut to the sequence, ``:154-157``, ``:230``) and the
  attention mask are combined *before* they become one additive
  ``finfo(dtype).min`` bias (``combine_masks``, ``:236``, ``:252-257``), so
  a row that may see no key (a left pad's query) is uniform over all keys;
- ``c_fc``, ``activation_function`` (``gelu_new`` by default), ``c_proj``.

A bucket longer than ``n_positions`` fails the reference (its mask cannot
broadcast); the port raises ``ValueError`` before it runs
(``bart.check_length``).  Plain ``torch.matmul`` and ``softmax``: no fused
attention.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch
from torch import nn

from lotus_tpu_torch.models.bart import check_length
from lotus_tpu_torch.models.bert import ACTIVATIONS, BertSelfAttention, EncoderConfig


def causal(s: int, device: torch.device | str) -> torch.Tensor:
    """(s, s) bool: query i may see keys 0 .. i."""
    return torch.ones((s, s), dtype=torch.bool, device=device).tril()


def decoder_bias(attention_mask: torch.Tensor, allowed: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Flax's decoders' additive bias, (b, 1, s, s): 0 where the key is in
    the row's mask and ``allowed`` (s, s) lets the query see it,
    ``finfo(dtype).min`` elsewhere (one min, never two summed)."""
    keep = (attention_mask[:, None, None, :] > 0) & allowed
    bias = torch.zeros(keep.shape, dtype=dtype, device=attention_mask.device)
    return bias.masked_fill(~keep, torch.finfo(dtype).min)


@dataclass(frozen=True)
class GPT2Config(EncoderConfig):
    """The fields of a GPT-2 ``config.json`` the forward reads (the defaults
    are ``transformers``' ``GPT2Config``'s)."""

    model_types: ClassVar[tuple[str, ...]] = ("gpt2", "gpt-sw3")  # GPT-SW3's CONFIG_MAPPING entry is GPT2Config
    activation_key: ClassVar[str] = "activation_function"

    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
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


class Conv1D(nn.Module):
    """GPT-2's projection: ``x @ weight + bias``, ``weight`` (in, out)."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_in, n_out))
        self.bias = nn.Parameter(torch.empty(n_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.weight) + self.bias


def split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(b, s, heads * d) -> (b, heads, s, d)."""
    b, s, _ = t.shape
    return t.view(b, s, heads, -1).transpose(1, 2)


class GPT2Attention(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.heads = cfg.n_head
        self.c_attn = Conv1D(cfg.n_embd, 3 * cfg.n_embd)
        self.c_proj = Conv1D(cfg.n_embd, cfg.n_embd)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        q, k, v = (split_heads(t, self.heads) for t in self.c_attn(x).chunk(3, dim=-1))
        return self.c_proj(BertSelfAttention.merge(BertSelfAttention.attend(q, k, v, bias)))


class GPT2MLP(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        inner = cfg.n_inner or 4 * cfg.n_embd
        self.c_fc = Conv1D(cfg.n_embd, inner)
        self.c_proj = Conv1D(inner, cfg.n_embd)
        self.act = ACTIVATIONS[cfg.activation_function]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(self.act(self.c_fc(x)))


class GPT2Block(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.ln_1 = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon)
        self.attn = GPT2Attention(cfg)
        self.ln_2 = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon)
        self.mlp = GPT2MLP(cfg)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), bias)
        return x + self.mlp(self.ln_2(x))


class GPT2Model(nn.Module):
    """The decoder: ``forward`` gives the last hidden state (b, s, n_embd)
    after ``ln_f``."""

    base_model_prefix = "transformer"
    block_cls: ClassVar[type[nn.Module]] = GPT2Block

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.config = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.wpe = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.h = nn.ModuleList(self.block_cls(cfg) for _ in range(self.num_blocks))
        self.ln_f = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_epsilon)

    @property
    def num_blocks(self) -> int:
        return self.config.n_layer

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        s = input_ids.shape[1]
        check_length(self.config, s)
        x = self.wte(input_ids) + self.wpe.weight[:s]
        for block, bias in zip(self.h, self.block_biases(attention_mask, x.dtype)):
            x = block(x, bias)
        return self.ln_f(x)

    def block_biases(self, attention_mask: torch.Tensor, dtype: torch.dtype) -> list[torch.Tensor]:
        """Each block's additive bias: one causal bias for every GPT-2 block."""
        bias = decoder_bias(attention_mask, causal(attention_mask.shape[1], attention_mask.device), dtype)
        return [bias] * len(self.h)
