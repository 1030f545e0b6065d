"""DistilBERT as ``nn.Module``s, under Hugging Face's names.

The forward is Flax DistilBERT's
(``transformers/models/distilbert/modeling_flax_distilbert.py``): word and
position embeddings, learned or sinusoidal (``sinusoidal_pos_embds``:
Flax's ``positional_encoding`` table, ``:97-113``, in place of any in the
checkpoint), no token types, LayerNorm at eps 1e-12 (``:102-143``); per
layer ``attention.{q_lin,k_lin,v_lin,out_lin}`` with the query scaled by
1/sqrt(head size) and the mask applied as ``scores - 1e30 * (1 - mask)``
(``:229``; not BERT's ``finfo.min`` bias, and in bf16 the two give other
logits), ``sa_layer_norm`` after the residual, ``ffn.{lin1,lin2}`` with the
exact GELU and ``output_layer_norm``.  The sequence classifier is
``pre_classifier``, ReLU and ``classifier`` on ``[CLS]`` (``:619-652``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import ClassVar

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lotus_tpu_torch.models.bert import EncoderConfig

LAYER_NORM_EPS = 1e-12  # fixed in the reference's modules, not read from the config


@dataclass(frozen=True)
class DistilBertConfig(EncoderConfig):
    """The fields of a DistilBERT ``config.json``, under its own names (the
    defaults are ``transformers``' ``DistilBertConfig``'s)."""

    model_types: ClassVar[tuple[str, ...]] = ("distilbert",)
    activation_key: ClassVar[str] = "activation"
    vocab_size: int = 30522
    max_position_embeddings: int = 512
    sinusoidal_pos_embds: bool = False
    n_layers: int = 6
    n_heads: int = 12
    dim: int = 768
    hidden_dim: int = 3072
    num_labels: int = 2

    @property
    def hidden_size(self) -> int:
        return self.dim

    @property
    def num_hidden_layers(self) -> int:
        return self.n_layers


@lru_cache(maxsize=None)
def sinusoidal_table(positions: int, dim: int) -> torch.Tensor:
    """Flax DistilBERT's ``positional_encoding``: sin on even columns, cos on
    odd, at angle pos / 10000^(2 * (i // 2) / dim); f32 on the CPU."""
    i = np.arange(dim)[np.newaxis, :]
    angles = np.arange(positions)[:, np.newaxis] * (1 / np.power(10000, (2 * (i // 2)) / np.float32(dim)))
    angles[:, 0::2] = np.sin(angles[:, 0::2])
    angles[:, 1::2] = np.cos(angles[:, 1::2])
    return torch.from_numpy(angles.astype(np.float32))


class DistilBertEmbeddings(nn.Module):
    def __init__(self, cfg: DistilBertConfig):
        super().__init__()
        self.config = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.dim)
        # Sinusoidal positions are no parameter: the table is made on the CPU
        # and copied to each forward's device (at most 512 x dim floats).
        self.position_embeddings = (None if cfg.sinusoidal_pos_embds
                                    else nn.Embedding(cfg.max_position_embeddings, cfg.dim))
        self.LayerNorm = nn.LayerNorm(cfg.dim, eps=LAYER_NORM_EPS)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = self.word_embeddings(input_ids)
        s = input_ids.shape[1]
        if self.position_embeddings is None:
            table = sinusoidal_table(self.config.max_position_embeddings, self.config.dim)
            pos = table[:s].to(x.device, x.dtype)
        else:
            pos = self.position_embeddings(torch.arange(s, device=input_ids.device))
        return self.LayerNorm(x + pos)


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, cfg: DistilBertConfig):
        super().__init__()
        self.heads = cfg.n_heads
        self.q_lin, self.k_lin, self.v_lin, self.out_lin = (nn.Linear(cfg.dim, cfg.dim) for _ in range(4))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, s, h = x.shape

        def split(t):  # (b, s, h) -> (b, heads, s, head size)
            return t.view(b, s, self.heads, h // self.heads).transpose(1, 2)

        q = split(self.q_lin(x)) / math.sqrt(h // self.heads)
        scores = torch.matmul(q, split(self.k_lin(x)).transpose(-1, -2))
        scores = scores - 1e30 * (1.0 - mask.to(scores.dtype)[:, None, None, :])
        ctx = torch.matmul(torch.softmax(scores, dim=-1), split(self.v_lin(x)))
        return self.out_lin(ctx.transpose(1, 2).reshape(b, s, h))


class FFN(nn.Module):
    def __init__(self, cfg: DistilBertConfig):
        super().__init__()
        self.lin1 = nn.Linear(cfg.dim, cfg.hidden_dim)
        self.lin2 = nn.Linear(cfg.hidden_dim, cfg.dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(F.gelu(self.lin1(x)))  # activation "gelu": the exact erf form


class TransformerBlock(nn.Module):
    def __init__(self, cfg: DistilBertConfig):
        super().__init__()
        self.attention = MultiHeadSelfAttention(cfg)
        self.sa_layer_norm = nn.LayerNorm(cfg.dim, eps=LAYER_NORM_EPS)
        self.ffn = FFN(cfg)
        self.output_layer_norm = nn.LayerNorm(cfg.dim, eps=LAYER_NORM_EPS)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.sa_layer_norm(self.attention(x, mask) + x)
        return self.output_layer_norm(self.ffn(x) + x)


class Transformer(nn.Module):
    def __init__(self, cfg: DistilBertConfig):
        super().__init__()
        self.layer = nn.ModuleList(TransformerBlock(cfg) for _ in range(cfg.n_layers))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        for layer in self.layer:
            x = layer(x, mask)
        return x


class DistilBertModel(nn.Module):
    """The encoder: ``forward`` gives the last hidden state (b, s, dim).
    DistilBERT has no token types; ``token_type_ids`` is ignored."""

    base_model_prefix = "distilbert"

    def __init__(self, cfg: DistilBertConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = DistilBertEmbeddings(cfg)
        self.transformer = Transformer(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: torch.Tensor | None = None) -> torch.Tensor:
        return self.transformer(self.embeddings(input_ids), attention_mask)


class DistilBertForSequenceClassification(nn.Module):
    """The encoder, ``pre_classifier``, ReLU and ``classifier`` on
    ``[CLS]``: ``forward`` gives the logits (b, num_labels)."""

    base_model_prefix = "distilbert"

    def __init__(self, cfg: DistilBertConfig):
        super().__init__()
        self.config = cfg
        self.distilbert = DistilBertModel(cfg)
        self.pre_classifier = nn.Linear(cfg.dim, cfg.dim)
        self.classifier = nn.Linear(cfg.dim, cfg.num_labels)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: torch.Tensor | None = None) -> torch.Tensor:
        hidden = self.distilbert(input_ids, attention_mask)
        return self.classifier(F.relu(self.pre_classifier(hidden[:, 0])))
