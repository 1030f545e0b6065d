"""RoFormer as ``nn.Module``s, under Hugging Face's names.

The forward is Flax RoFormer's
(``transformers/models/roformer/modeling_flax_roformer.py``): word and
token-type embeddings and LayerNorm, with no position embeddings
(``:131-162``); BERT's layers (``bert.py``) whose self-attention turns the
query and key (and the value, with ``rotary_value``) by rotary positions
before the product (``:165-281``).  The sinusoid table is Flax's
``create_sinusoidal_positions(max_position_embeddings, head size)``
(``:120-128``): sin of pos / 10000^(2 * (j // 2) / dim) over the even j in
the first half of each row, cos over the odd j in the second;
``apply_rotary_position_embeddings`` repeats each sin and cos twice, pair
by pair, and turns x into x * cos + (-x1, x0, -x3, x2, ...) * sin.  The
table is computed, never loaded: a torch checkpoint's
``encoder.embed_positions.weight`` is held to it as it loads.
There is no pooler.  The sequence classifier is
``RoFormerClassificationHead`` (``:570-595``): ``dense``, ``hidden_act``
and ``out_proj`` on token 0.  Called without token types, every token is
in segment 0.

Flax RoFormer embeds at the hidden size and has no ``embeddings_project``,
so the reference cannot load a checkpoint whose ``embedding_size`` differs
from its hidden size; the port refuses one too.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import ClassVar

import numpy as np
import torch
from torch import nn

from lotus_tpu_torch.models.bert import ACTIVATIONS, BertEncoder, BertModel, BertSelfAttention, EncoderConfig
from lotus_tpu_torch.models.roberta import RobertaClassificationHead

TABLE_ATOL = 1e-2  # a checkpoint's sinusoid table against the computed one: admits f16 / bf16 storage


@dataclass(frozen=True)
class RoFormerConfig(EncoderConfig):
    """The fields of a RoFormer ``config.json`` the forward reads (the
    defaults are ``transformers``' ``RoFormerConfig``'s)."""

    model_types: ClassVar[tuple[str, ...]] = ("roformer",)
    vocab_size: int = 50000
    embedding_size: int | None = None
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    max_position_embeddings: int = 1536
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    rotary_value: bool = False
    num_labels: int = 2

    def __post_init__(self):
        if self.embedding_size not in (None, self.hidden_size):
            raise NotImplementedError(
                f"RoFormer embedding_size {self.embedding_size} != hidden_size {self.hidden_size}: Flax RoFormer, the "
                f"reference, embeds at the hidden size and has no embeddings_project, so it cannot load this "
                f"checkpoint, and the port refuses it too")


@lru_cache(maxsize=None)
def sinusoidal_positions(n_pos: int, dim: int) -> torch.Tensor:
    """Flax's ``create_sinusoidal_positions``: (n_pos, dim) f32 on the CPU,
    sin in the first ceil(dim / 2) columns, cos in the rest."""
    j = np.arange(dim)
    angles = np.arange(n_pos)[:, None] / np.power(10000, 2 * (j // 2) / dim)[None, :]
    half = dim // 2 + dim % 2
    out = np.zeros_like(angles)
    out[:, :half] = np.sin(angles[:, 0::2])
    out[:, half:] = np.cos(angles[:, 1::2])
    return torch.from_numpy(out.astype(np.float32))


def check_table(table: torch.Tensor, cfg: RoFormerConfig) -> None:
    """A checkpoint's ``embed_positions.weight`` must be the computed table."""
    want = sinusoidal_positions(cfg.max_position_embeddings, cfg.hidden_size // cfg.num_attention_heads)
    if table.shape != want.shape or not torch.allclose(table.float(), want.to(table.device), atol=TABLE_ATOL):
        raise ValueError(f"the checkpoint's embed_positions.weight {tuple(table.shape)} is not the sinusoid table "
                         f"{tuple(want.shape)} Flax RoFormer computes")


def rotate(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x (b, heads, s, d) turned by positions: ``sin`` and ``cos`` (s, d),
    each value repeated for its pair."""
    turned = torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).reshape(x.shape)
    return x * cos + turned * sin


class RoFormerSelfAttention(BertSelfAttention):
    """BERT's self-attention with rotary positions; reads (mask bias, sin,
    cos) from its encoder."""

    def __init__(self, cfg: RoFormerConfig):
        super().__init__(cfg)
        self.rotary_value = cfg.rotary_value

    def forward(self, x: torch.Tensor, ctx: tuple[torch.Tensor, torch.Tensor, torch.Tensor]) -> torch.Tensor:
        bias, sin, cos = ctx
        q, k, v = self.heads_of(x)
        q, k = rotate(q, sin, cos), rotate(k, sin, cos)
        if self.rotary_value:
            v = rotate(v, sin, cos)
        return self.merge(self.attend(q, k, v, bias))


def _take_table(module: "RoFormerEncoder", state: dict, prefix: str, *_) -> None:
    """A torch checkpoint's ``embed_positions.weight`` is checked against the
    computed table and never loaded."""
    table = state.pop(prefix + "embed_positions.weight", None)
    if table is not None:
        check_table(table, module.config)


class RoFormerEncoder(BertEncoder):
    def __init__(self, cfg: RoFormerConfig):
        super().__init__(cfg, RoFormerSelfAttention)
        self.config = cfg
        self.register_load_state_dict_pre_hook(_take_table)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        table = sinusoidal_positions(cfg.max_position_embeddings, cfg.hidden_size // cfg.num_attention_heads)
        sin, cos = table[: x.shape[1]].to(x.device, x.dtype).chunk(2, dim=-1)
        return super().forward(x, (bias, sin.repeat_interleave(2, -1), cos.repeat_interleave(2, -1)))


class RoFormerEmbeddings(nn.Module):
    def __init__(self, cfg: RoFormerConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor, token_type_ids: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.word_embeddings(input_ids) + self.token_type_embeddings(token_type_ids))


class RoFormerModel(BertModel):
    """The encoder: ``forward`` gives the last hidden state (b, s, hidden)."""

    base_model_prefix = "roformer"
    embeddings_cls = RoFormerEmbeddings
    encoder_cls = RoFormerEncoder

    def __init__(self, cfg: RoFormerConfig):
        super().__init__(cfg, add_pooling_layer=False)


class RoFormerForSequenceClassification(nn.Module):
    """The encoder and ``RoFormerClassificationHead``: ``forward`` gives the
    logits (b, num_labels)."""

    base_model_prefix = "roformer"

    def __init__(self, cfg: RoFormerConfig):
        super().__init__()
        self.config = cfg
        self.roformer = RoFormerModel(cfg)
        self.classifier = RobertaClassificationHead(cfg, ACTIVATIONS[cfg.hidden_act])

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: torch.Tensor | None = None) -> torch.Tensor:
        return self.classifier(self.roformer(input_ids, attention_mask, token_type_ids))
