"""Marian as ``nn.Module``s, under Hugging Face's names (an RM only: the Flax
sequence-classification auto class does not map the type).

The forward is Flax Marian's (``transformers/models/marian/modeling_flax_marian.py``):
BART's skeleton (``bart.py``) with the LayerNorm after each residual
(post-LN), no ``layernorm_embedding`` and no final ``layer_norm``, the
token embeddings scaled by sqrt(d_model) under ``scale_embedding``, and
sinusoidal positions from row 0 (``create_sinusoidal_positions``,
``:219-226``, ``:695``, ``:713``), computed and never loaded, as Pegasus's
(``pegasus.Sinusoidal``: a torch checkpoint's ``embed_positions.weight`` is
held to the table as it loads).

Flax builds one ``shared`` embedding for both stacks (``:809-816``),
whatever ``share_encoder_decoder_embeddings`` says: as for every BART-type
model (``bart._tie_embeddings``), a torch checkpoint whose
``encoder.embed_tokens.weight`` or ``decoder.embed_tokens.weight`` differs
from the one loaded (``shared``, else the first of the two) cannot be tied
so, and raises ``ValueError`` naming it.  The decoder reads the
ids shifted right behind ``decoder_start_token_id``; a
``decoder_start_token_id`` or ``pad_token_id`` outside the vocabulary
raises ``ValueError`` (Flax gathers NaN rows there, so the reference's
embeddings are not finite).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

from lotus_tpu_torch.models.bart import BartConfig, BartDecoder, BartEncoder, BartModel
from lotus_tpu_torch.models.pegasus import Sinusoidal


@dataclass(frozen=True)
class MarianConfig(BartConfig):
    """The fields of a Marian ``config.json`` the forward reads (the
    defaults are ``transformers``' ``MarianConfig``'s)."""

    model_types: ClassVar[tuple[str, ...]] = ("marian",)
    embedding_norm: ClassVar[bool] = False
    position_offset: ClassVar[int | None] = None

    vocab_size: int = 58101
    pad_token_id: int = 58100
    eos_token_id: int = 0
    decoder_start_token_id: int | None = 58100


class MarianEncoder(Sinusoidal, BartEncoder):
    pass


class MarianDecoder(Sinusoidal, BartDecoder):
    pass


class MarianModel(BartModel):
    encoder_cls = MarianEncoder
    decoder_cls = MarianDecoder

    def __init__(self, cfg: MarianConfig):
        for key in ("decoder_start_token_id", "pad_token_id"):
            value = getattr(cfg, key)
            if value is None or not 0 <= value < cfg.vocab_size:
                raise ValueError(f"{key} {value} lies outside the {cfg.vocab_size}-entry vocabulary: the reference's "
                                 f"Flax Marian gathers NaN rows for it, so its embeddings are not finite")
        super().__init__(cfg)
