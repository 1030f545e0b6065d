"""ELECTRA as ``nn.Module``s, under Hugging Face's names.

The forward is Flax ELECTRA's
(``transformers/models/electra/modeling_flax_electra.py``): BERT's
embeddings at ``embedding_size``, projected to the hidden size by
``embeddings_project`` where the two differ (``:876``, ``:899-900``), then
BERT's layers (``bert.py``).  There is no pooler.  Called without token
types, as the RM and the reranker call it, every token is in segment 1:
Flax ELECTRA's ``__call__`` fills them with ones (``:796``), where Flax
BERT and RoBERTa fill zeros.  The sequence classifier
is ``ElectraClassificationHead`` (``:1401-1423``): ``dense``, the exact erf
GELU (``ACT2FN["gelu"]``, where BERT's pooler has tanh) and ``out_proj`` on
``[CLS]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch
import torch.nn.functional as F
from torch import nn

from lotus_tpu_torch.models.bert import BertConfig, BertEmbeddings, BertEncoder, BertModel
from lotus_tpu_torch.models.roberta import RobertaClassificationHead


@dataclass(frozen=True)
class ElectraConfig(BertConfig):
    """The fields of an ELECTRA ``config.json`` the forward reads (the
    defaults are ``transformers``' ``ElectraConfig``'s)."""

    model_types: ClassVar[tuple[str, ...]] = ("electra",)
    vocab_size: int = 30522
    hidden_size: int = 256
    num_attention_heads: int = 4
    intermediate_size: int = 1024
    embedding_size: int = 128


class ElectraModel(BertModel):
    """The encoder: ``forward`` gives the last hidden state (b, s, hidden)."""

    base_model_prefix = "electra"
    # Flax ELECTRA fills absent token types with ones, where Flax BERT and
    # RoBERTa fill zeros (modeling_flax_electra.py:796).
    absent_token_type = 1

    def __init__(self, cfg: ElectraConfig):
        nn.Module.__init__(self)
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg, cfg.embedding_size)
        self.embeddings_project = (nn.Linear(cfg.embedding_size, cfg.hidden_size)
                                   if cfg.embedding_size != cfg.hidden_size else None)
        self.encoder = BertEncoder(cfg)
        self.pooler = None

    def embed(self, input_ids: torch.Tensor, token_type_ids: torch.Tensor) -> torch.Tensor:
        x = self.embeddings(input_ids, token_type_ids)
        return x if self.embeddings_project is None else self.embeddings_project(x)


class ElectraForSequenceClassification(nn.Module):
    """The encoder and the reference's ``ElectraClassificationHead``
    (RoBERTa's head with the exact GELU in place of tanh): ``forward`` gives
    the logits (b, num_labels)."""

    base_model_prefix = "electra"

    def __init__(self, cfg: ElectraConfig):
        super().__init__()
        self.config = cfg
        self.electra = ElectraModel(cfg)
        self.classifier = RobertaClassificationHead(cfg, F.gelu)  # the exact erf GELU, as the reference's head

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: torch.Tensor | None = None) -> torch.Tensor:
        return self.classifier(self.electra(input_ids, attention_mask, token_type_ids))
