"""BLOOM as ``nn.Module``s, under Hugging Face's names (an RM only: the Flax
sequence-classification auto class does not map the type).

The forward is Flax BLOOM's (``transformers/models/bloom/modeling_flax_bloom.py``):

- token embeddings ``word_embeddings``, then a LayerNorm
  (``word_embeddings_layernorm``); no position embeddings (``:352-391``);
- ALiBi in their place (``build_alibi_tensor``, ``:111-150``): head h's
  slope times each key's position, added to the attention bias of every
  query.  The slopes are ``base ** (1 .. p)`` for ``p`` the largest power of
  two up to the head count, ``base = 2 ** -(2 ** -(log2(p) - 3))``, and
  past ``p`` (BLOOM-176B's 112 heads) the odd powers ``1, 3, ..`` of
  ``2 ** -(2 ** -(log2(2p) - 3))``; made in f32 as XLA makes them (the f32
  base's powers, correctly rounded).  A key's position is
  ``(cumsum(mask) - 1) * mask``, so a left-padded row starts at 0.  The
  table is cast to the hidden dtype (rounded to bf16 in a bf16 run) and
  added there to the ``finfo(dtype).min`` mask bias (``:269-289``), which
  combines the causal and attention masks before one ``min``
  (``gpt2.decoder_bias``): a query that may see no key (a left pad's) is
  uniform over all keys.  Transformers 4.57's Flax code joins the two
  slope lists with ``jnp.cat``, which JAX 0.9 does not have, so the
  reference raises ``AttributeError`` on a head count that is not a power
  of two; the port computes the branch the code spells out (torch BLOOM's
  ``torch.cat``);
- per block (``h.<i>``): ``input_layernorm``; the fused
  ``self_attention.query_key_value`` reshaped to (heads, 3 x head size) and
  cut per head into q, k and v (``:178-179``, not into thirds of the
  width); the query scaled by 1/sqrt(head size); below f32 the scores and
  softmax in f32 (``attention_softmax_in_fp32``), the weights cast back;
  ``self_attention.dense`` plus the residual; ``post_attention_layernorm``;
  ``mlp.dense_h_to_4h``, BLOOM's tanh GELU ``x * 0.5 * (1 + tanh(0.79788456
  * x * (1 + 0.044715 * x * x)))`` (``BloomGELU``, ``:307-311``),
  ``mlp.dense_4h_to_h`` plus the residual.  The residuals are the block's
  input and the attention's output, or with
  ``apply_residual_connection_post_layernorm`` the two LayerNorms' outputs
  (``:352-391``);
- a final ``ln_f``.

ALiBi reads no table, so any bucket runs.  ``config.json`` may name the
width ``n_embed`` (BLOOM-7b1's) and the depth and heads
``num_hidden_layers`` / ``num_attention_heads``, as ``BloomConfig`` reads
them.  Plain ``nn.Linear``, ``torch.matmul`` and ``softmax``: no fused
attention.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar

import numpy as np
import torch
from torch import nn

from lotus_tpu_torch.models.bert import BertSelfAttention, EncoderConfig
from lotus_tpu_torch.models.gpt2 import causal, decoder_bias


@dataclass(frozen=True)
class BloomConfig(EncoderConfig):
    """The fields of a BLOOM ``config.json`` the forward reads (the defaults
    are ``transformers``' ``BloomConfig``'s), also under the names
    ``BloomConfig`` takes for them (``n_embed`` and its ``attribute_map``)."""

    model_types: ClassVar[tuple[str, ...]] = ("bloom",)
    aliases: ClassVar[dict[str, str]] = {"n_embed": "hidden_size", "num_hidden_layers": "n_layer",
                                         "num_attention_heads": "n_head"}

    vocab_size: int = 250880
    hidden_size: int = 64
    n_layer: int = 2
    n_head: int = 8
    layer_norm_epsilon: float = 1e-5
    apply_residual_connection_post_layernorm: bool = False
    num_labels: int = 2


def alibi_slopes(heads: int) -> torch.Tensor:
    """(heads,) f32: each head's ALiBi slope (the module's docstring)."""
    closest = 2 ** math.floor(math.log2(heads))

    def powers(base: float, exponents: np.ndarray) -> np.ndarray:
        return np.power(np.float64(np.float32(base)), exponents).astype(np.float32)

    slopes = powers(2 ** (-(2 ** -(math.log2(closest) - 3))), np.arange(1, 1 + closest))
    if closest != heads:
        extra = min(closest, heads - closest)
        slopes = np.concatenate([slopes, powers(2 ** (-(2 ** -(math.log2(2 * closest) - 3))),
                                                np.arange(1, 1 + 2 * extra, 2))])
    return torch.from_numpy(slopes)


def build_alibi(attention_mask: torch.Tensor, heads: int, dtype: torch.dtype) -> torch.Tensor:
    """(b, heads, 1, s) in ``dtype``: each head's slope times each key's
    position ``(cumsum(mask) - 1) * mask``, computed in f32."""
    positions = (attention_mask.cumsum(-1) - 1) * attention_mask
    slopes = alibi_slopes(heads).to(attention_mask.device)
    return (slopes[:, None] * positions[:, None, :].float())[:, :, None, :].to(dtype)


def bloom_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * 0.5 * (1.0 + torch.tanh(0.79788456 * x * (1 + 0.044715 * x * x)))


class BloomAttention(nn.Module):
    def __init__(self, cfg: BloomConfig):
        super().__init__()
        self.heads = cfg.n_head
        self.query_key_value = nn.Linear(cfg.hidden_size, 3 * cfg.hidden_size)
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor, residual: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, s, width = x.shape
        fused = self.query_key_value(x).view(b, s, self.heads, 3 * (width // self.heads))
        q, k, v = (t.transpose(1, 2) for t in fused.chunk(3, dim=-1))  # each head's own thirds
        if x.dtype == torch.float32:
            ctx = BertSelfAttention.attend(q, k, v, bias)
        else:  # attention_softmax_in_fp32: the scores and softmax in f32
            scores = torch.matmul(q.float() / math.sqrt(q.shape[-1]), k.float().transpose(-1, -2)) + bias.float()
            ctx = torch.matmul(torch.softmax(scores, dim=-1).to(x.dtype), v)
        return self.dense(BertSelfAttention.merge(ctx)) + residual


class BloomMLP(nn.Module):
    def __init__(self, cfg: BloomConfig):
        super().__init__()
        self.dense_h_to_4h = nn.Linear(cfg.hidden_size, 4 * cfg.hidden_size)
        self.dense_4h_to_h = nn.Linear(4 * cfg.hidden_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.dense_4h_to_h(bloom_gelu(self.dense_h_to_4h(x))) + residual


class BloomBlock(nn.Module):
    def __init__(self, cfg: BloomConfig):
        super().__init__()
        self.post_norm_residual = cfg.apply_residual_connection_post_layernorm
        self.input_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_epsilon)
        self.self_attention = BloomAttention(cfg)
        self.post_attention_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_epsilon)
        self.mlp = BloomMLP(cfg)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        normed = self.input_layernorm(x)
        attn = self.self_attention(normed, normed if self.post_norm_residual else x, bias)
        normed = self.post_attention_layernorm(attn)
        return self.mlp(normed, normed if self.post_norm_residual else attn)


class BloomModel(nn.Module):
    """The decoder: ``forward`` gives the last hidden state (b, s, hidden)
    after ``ln_f``."""

    base_model_prefix = "transformer"

    def __init__(self, cfg: BloomConfig):
        super().__init__()
        self.config = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.word_embeddings_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_epsilon)
        self.h = nn.ModuleList(BloomBlock(cfg) for _ in range(cfg.n_layer))
        self.ln_f = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_epsilon)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        x = self.word_embeddings_layernorm(self.word_embeddings(input_ids))
        allowed = causal(input_ids.shape[1], input_ids.device)
        bias = decoder_bias(attention_mask, allowed, x.dtype) + build_alibi(attention_mask, self.config.n_head,
                                                                            x.dtype)
        for block in self.h:
            x = block(x, bias)
        return self.ln_f(x)
