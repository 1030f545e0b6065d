"""RoBERTa-PreLayerNorm as ``nn.Module``s, under Hugging Face's names.

The forward is Flax RoBERTa-PreLayerNorm's
(``transformers/models/roberta_prelayernorm/modeling_flax_roberta_prelayernorm.py``):
RoBERTa's embeddings and position ids (``roberta.py``); per layer the
LayerNorm moves before each block, ``x + output(self(attention.LayerNorm(x)))``
(``:375-416``) and ``x + output(act(intermediate.dense(intermediate.LayerNorm(x))))``
(``:419-455``), with no LayerNorm after the residuals; a final
``LayerNorm`` over the encoder's output (``:974``), which the pooler and
the heads read.  The sequence classifier is RoBERTa's
``RobertaClassificationHead`` on token 0, with no pooler.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch
from torch import nn

from lotus_tpu_torch.models.bert import ACTIVATIONS, BertSelfAttention
from lotus_tpu_torch.models.roberta import RobertaClassificationHead, RobertaConfig, RobertaModel


@dataclass(frozen=True)
class RobertaPreLayerNormConfig(RobertaConfig):
    """The fields of a RoBERTa-PreLayerNorm ``config.json`` the forward
    reads (the defaults are ``transformers``' ``RobertaPreLayerNormConfig``'s)."""

    model_types: ClassVar[tuple[str, ...]] = ("roberta-prelayernorm",)


class PreLayerNormSelfOutput(nn.Module):
    def __init__(self, cfg: RobertaPreLayerNormConfig, width: int):
        super().__init__()
        self.dense = nn.Linear(width, cfg.hidden_size)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.dense(x) + residual


class PreLayerNormAttention(nn.Module):
    def __init__(self, cfg: RobertaPreLayerNormConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = PreLayerNormSelfOutput(cfg, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return self.output(self.self(self.LayerNorm(x), bias), x)


class PreLayerNormIntermediate(nn.Module):
    def __init__(self, cfg: RobertaPreLayerNormConfig):
        super().__init__()
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.act = ACTIVATIONS[cfg.hidden_act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.dense(self.LayerNorm(x)))


class PreLayerNormLayer(nn.Module):
    def __init__(self, cfg: RobertaPreLayerNormConfig):
        super().__init__()
        self.attention = PreLayerNormAttention(cfg)
        self.intermediate = PreLayerNormIntermediate(cfg)
        self.output = PreLayerNormSelfOutput(cfg, cfg.intermediate_size)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = self.attention(x, bias)
        return self.output(self.intermediate(x), x)


class PreLayerNormEncoder(nn.Module):
    def __init__(self, cfg: RobertaPreLayerNormConfig):
        super().__init__()
        self.layer = nn.ModuleList(PreLayerNormLayer(cfg) for _ in range(cfg.num_hidden_layers))

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        for layer in self.layer:
            x = layer(x, bias)
        return x


class RobertaPreLayerNormModel(RobertaModel):
    """The encoder: ``forward`` gives the last hidden state (b, s, hidden),
    after the final ``LayerNorm``."""

    base_model_prefix = "roberta_prelayernorm"
    encoder_cls = PreLayerNormEncoder

    def __init__(self, cfg: RobertaPreLayerNormConfig, add_pooling_layer: bool = True):
        super().__init__(cfg, add_pooling_layer)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: torch.Tensor | None = None) -> torch.Tensor:
        return self.LayerNorm(super().forward(input_ids, attention_mask, token_type_ids))


class RobertaPreLayerNormForSequenceClassification(nn.Module):
    """The encoder (no pooler) and ``RobertaClassificationHead``:
    ``forward`` gives the logits (b, num_labels)."""

    base_model_prefix = "roberta_prelayernorm"

    def __init__(self, cfg: RobertaPreLayerNormConfig):
        super().__init__()
        self.config = cfg
        self.roberta_prelayernorm = RobertaPreLayerNormModel(cfg, add_pooling_layer=False)
        self.classifier = RobertaClassificationHead(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: torch.Tensor | None = None) -> torch.Tensor:
        return self.classifier(self.roberta_prelayernorm(input_ids, attention_mask, token_type_ids))
