"""RoBERTa and XLM-RoBERTa as ``nn.Module``s, under Hugging Face's names.

The forward is Flax RoBERTa's
(``transformers/models/roberta/modeling_flax_roberta.py``), which
``FlaxXLMRobertaModel`` copies; the two families differ only in their
tokenizer.  The layers are BERT's (``bert.py``) under ``roberta.``; the
embeddings take their position ids from the input ids
(``create_position_ids_from_input_ids``, ``:52-73``): the running count of
tokens that are not ``pad_token_id``, times that mask, plus
``pad_token_id``, so the first real token sits at ``pad_token_id + 1`` (2)
and every pad at ``pad_token_id``.  The sequence classifier is
``RobertaClassificationHead`` (``:691-719``): ``dense``, tanh and
``out_proj`` on token 0, with no pooler.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, ClassVar

import torch
from torch import nn

from lotus_tpu_torch.models.bert import BertConfig, BertEmbeddings, BertModel


@dataclass(frozen=True)
class RobertaConfig(BertConfig):
    """The fields of a RoBERTa or XLM-R ``config.json`` the forward reads
    (the defaults are ``transformers``' ``RobertaConfig``'s)."""

    model_types: ClassVar[tuple[str, ...]] = ("roberta", "xlm-roberta")
    vocab_size: int = 50265
    pad_token_id: int = 1


class RobertaEmbeddings(BertEmbeddings):
    def __init__(self, cfg: RobertaConfig):
        super().__init__(cfg)
        self.padding_idx = cfg.pad_token_id

    def forward(self, input_ids: torch.Tensor, token_type_ids: torch.Tensor,
                positions: torch.Tensor | None = None) -> torch.Tensor:
        real = (input_ids != self.padding_idx).long()
        return super().forward(input_ids, token_type_ids, torch.cumsum(real, 1) * real + self.padding_idx)


class RobertaModel(BertModel):
    """The encoder: ``forward`` gives the last hidden state (b, s, hidden)."""

    base_model_prefix = "roberta"
    embeddings_cls = RobertaEmbeddings


class RobertaClassificationHead(nn.Module):
    """``dense``, ``act`` (RoBERTa's tanh; ELECTRA, RoFormer and BigBird
    give theirs) and ``out_proj`` on token 0."""

    def __init__(self, cfg: BertConfig, act: Callable[[torch.Tensor], torch.Tensor] = torch.tanh):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.out_proj = nn.Linear(cfg.hidden_size, cfg.num_labels)
        self.act = act

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.out_proj(self.act(self.dense(hidden[:, 0])))


class RobertaForSequenceClassification(nn.Module):
    """The encoder (no pooler) and ``RobertaClassificationHead``:
    ``forward`` gives the logits (b, num_labels)."""

    base_model_prefix = "roberta"

    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.config = cfg
        self.roberta = RobertaModel(cfg, add_pooling_layer=False)
        self.classifier = RobertaClassificationHead(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: torch.Tensor | None = None) -> torch.Tensor:
        return self.classifier(self.roberta(input_ids, attention_mask, token_type_ids))
