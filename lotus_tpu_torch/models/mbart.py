"""mBART as ``nn.Module``s, under Hugging Face's names.

The forward is Flax mBART's
(``transformers/models/mbart/modeling_flax_mbart.py``): BART's skeleton
(``bart.py``) with the LayerNorm before each block, a final ``layer_norm``
over the encoder and over the decoder (``:733-734``, ``:809-810``),
``layernorm_embedding`` after the embeddings and learned positions at offset
2.  The decoder's inputs come from mBART's own shift (``:220-235``), which
has no start token: it moves each row's last non-pad token (the language id
the tokenizer appends) to the front.  The sequence classifier is BART's,
over the decoder states at every ``</s>`` (``:1636-1647``, skipped under
``jit`` as in BART).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch

from lotus_tpu_torch.models.bart import BartConfig, BartForSequenceClassification, BartModel


@dataclass(frozen=True)
class MBartConfig(BartConfig):
    """The fields of an mBART ``config.json`` the forward reads (the
    defaults are ``transformers``' ``MBartConfig``'s)."""

    model_types: ClassVar[tuple[str, ...]] = ("mbart",)
    pre_norm: ClassVar[bool] = True

    vocab_size: int = 50265
    decoder_start_token_id: int | None = None
    num_labels: int = 2


def shift_tokens_right(input_ids: torch.Tensor, pad_token_id: int) -> torch.Tensor:
    """mBART's decoder inputs: each row's last non-pad token (its index the
    count of non-pad tokens less one, so a row of pads takes its last),
    then the ids but the last."""
    last = ((input_ids != pad_token_id).sum(dim=1, keepdim=True) - 1) % input_ids.shape[1]
    return torch.cat([input_ids.gather(1, last), input_ids[:, :-1]], dim=1)


class MBartModel(BartModel):
    """The encoder-decoder: ``forward`` gives the decoder's last hidden
    state, after the decoder's final ``layer_norm``."""

    def decoder_inputs(self, input_ids: torch.Tensor) -> torch.Tensor:
        return shift_tokens_right(input_ids, self.config.pad_token_id)


class MBartForSequenceClassification(BartForSequenceClassification):
    model_cls = MBartModel
