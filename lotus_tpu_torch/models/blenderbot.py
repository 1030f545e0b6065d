"""Blenderbot as ``nn.Module``s, under Hugging Face's names (an RM only:
the Flax sequence-classification auto class does not map the type).

The forward is Flax Blenderbot's
(``transformers/models/blenderbot/modeling_flax_blenderbot.py``): BART's
skeleton (``bart.py``) with the LayerNorm before each block and a final
``layer_norm`` over each stack, no ``layernorm_embedding``, and learned
positions read from row ``position_ids`` itself, without BART's offset
(``:672``, ``:741``).  Its published checkpoints have 128 positions, so
``bart.check_length`` refuses the RM's default 512-token buckets past 128,
as the reference fails on them.  The modules are BART's, read under this
config.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

from lotus_tpu_torch.models.bart import BartConfig


@dataclass(frozen=True)
class BlenderbotConfig(BartConfig):
    """The fields of a Blenderbot ``config.json`` the forward reads (the
    defaults are ``transformers``' ``BlenderbotConfig``'s)."""

    model_types: ClassVar[tuple[str, ...]] = ("blenderbot",)
    pre_norm: ClassVar[bool] = True
    embedding_norm: ClassVar[bool] = False
    position_offset: ClassVar[int | None] = 0

    vocab_size: int = 8008
    max_position_embeddings: int = 128
    d_model: int = 2560
    encoder_layers: int = 2
    encoder_ffn_dim: int = 10240
    encoder_attention_heads: int = 32
    decoder_layers: int = 24
    decoder_ffn_dim: int = 10240
    decoder_attention_heads: int = 32
    pad_token_id: int = 0
    eos_token_id: int = 2
    decoder_start_token_id: int | None = 1
    num_labels: int = 2
