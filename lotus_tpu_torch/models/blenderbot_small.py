"""Blenderbot-Small as ``nn.Module``s, under Hugging Face's names (an RM
only: the Flax sequence-classification auto class does not map the type).

The forward is Flax Blenderbot-Small's
(``transformers/models/blenderbot_small/modeling_flax_blenderbot_small.py``):
BART's skeleton (``bart.py``), post-LN with ``layernorm_embedding``, and
learned positions read from row ``position_ids`` itself, without BART's
offset.  The two stacks normalise in different orders: the encoder
normalises the sum of token and position embeddings (``:705-710``), the
decoder the token embeddings alone, before it adds the positions
(``:770-777``).  Its tokenizer is ``blenderbot_small_tokenizer.py``'s.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch
from torch import nn

from lotus_tpu_torch.models.bart import BartConfig, BartDecoder, BartModel


@dataclass(frozen=True)
class BlenderbotSmallConfig(BartConfig):
    """The fields of a Blenderbot-Small ``config.json`` the forward reads
    (the defaults are ``transformers``' ``BlenderbotSmallConfig``'s)."""

    model_types: ClassVar[tuple[str, ...]] = ("blenderbot-small",)
    position_offset: ClassVar[int | None] = 0

    max_position_embeddings: int = 512
    d_model: int = 512
    encoder_layers: int = 8
    encoder_ffn_dim: int = 2048
    encoder_attention_heads: int = 16
    decoder_layers: int = 8
    decoder_ffn_dim: int = 2048
    decoder_attention_heads: int = 16
    pad_token_id: int = 0
    eos_token_id: int = 2
    decoder_start_token_id: int | None = 1
    num_labels: int = 2


class BlenderbotSmallDecoder(BartDecoder):
    def embed(self, embed_tokens: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
        x = self.layernorm_embedding(embed_tokens(ids) * self.scale)
        return x + self.positions(ids.shape[1], embed_tokens.weight)


class BlenderbotSmallModel(BartModel):
    decoder_cls = BlenderbotSmallDecoder
