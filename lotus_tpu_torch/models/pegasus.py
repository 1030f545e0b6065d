"""Pegasus as ``nn.Module``s, under Hugging Face's names (an RM only: the
Flax sequence-classification auto class does not map the type).

The forward is Flax Pegasus's
(``transformers/models/pegasus/modeling_flax_pegasus.py``): BART's skeleton
(``bart.py``) with the LayerNorm before each block and a final
``layer_norm`` over each stack, no ``layernorm_embedding``, and sinusoidal
positions: Flax's ``create_sinusoidal_positions(max_position_embeddings,
d_model)`` (``:225``, ``:688``, ``:755``; ``roformer.sinusoidal_positions``
computes the same table), cast to the embeddings' dtype.  The table is
computed, never loaded: a torch checkpoint's ``embed_positions.weight`` is
held to it as it loads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch

from lotus_tpu_torch.models.bart import BartConfig, BartDecoder, BartEncoder, BartModel
from lotus_tpu_torch.models.roformer import TABLE_ATOL, sinusoidal_positions


@dataclass(frozen=True)
class PegasusConfig(BartConfig):
    """The fields of a Pegasus ``config.json`` the forward reads (the
    defaults are ``transformers``' ``PegasusConfig``'s)."""

    model_types: ClassVar[tuple[str, ...]] = ("pegasus",)
    pre_norm: ClassVar[bool] = True
    embedding_norm: ClassVar[bool] = False
    position_offset: ClassVar[int | None] = None

    pad_token_id: int = 0
    eos_token_id: int = 1
    decoder_start_token_id: int | None = 0
    num_labels: int = 2


def _take_table(module: "Sinusoidal", state: dict, prefix: str, *_) -> None:
    """A torch checkpoint's ``embed_positions.weight`` is checked against the
    computed table and never loaded."""
    table = state.pop(prefix + "embed_positions.weight", None)
    if table is None:
        return
    cfg = module.config
    want = sinusoidal_positions(cfg.max_position_embeddings, cfg.d_model)
    if table.shape != want.shape or not torch.allclose(table.float(), want.to(table.device), atol=TABLE_ATOL):
        raise ValueError(f"the checkpoint's {prefix}embed_positions.weight {tuple(table.shape)} is not the sinusoid "
                         f"table {tuple(want.shape)} Flax {cfg.model_types[0].capitalize()} computes")


class Sinusoidal:
    """A stack's positions from the computed table (made on the CPU, copied
    to each forward's device: at most max_position_embeddings x d_model
    floats)."""

    def __init__(self, cfg: PegasusConfig):
        super().__init__(cfg)
        self.register_load_state_dict_pre_hook(_take_table)

    def positions(self, s: int, like: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        return sinusoidal_positions(cfg.max_position_embeddings, cfg.d_model)[:s].to(like.device, like.dtype)


class PegasusEncoder(Sinusoidal, BartEncoder):
    pass


class PegasusDecoder(Sinusoidal, BartDecoder):
    pass


class PegasusModel(BartModel):
    encoder_cls = PegasusEncoder
    decoder_cls = PegasusDecoder
