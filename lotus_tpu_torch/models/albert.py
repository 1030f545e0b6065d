"""ALBERT as ``nn.Module``s, under Hugging Face's names.

The forward is Flax ALBERT's
(``transformers/models/albert/modeling_flax_albert.py``): BERT's word +
token-type + position embeddings and LayerNorm at ``embedding_size``
(``:151-186``), projected to the hidden size by
``encoder.embedding_hidden_mapping_in`` (``:481-506``); then
``num_hidden_layers`` layers whose parameters are shared: layer i runs
group ``int(i / (num_hidden_layers / num_hidden_groups))`` (``:446-459``),
and a group runs its ``inner_group_num`` layers in turn.  A layer is
attention (q/k/v, the query scaled before the product, Flax's
``finfo.min`` mask bias, ``dense``, the residual and ``LayerNorm``), then
``ffn``, ``hidden_act`` (``gelu_new`` in the published configs),
``ffn_output``, the residual and ``full_layer_layer_norm`` (``:274-309``).
The pooler is ``pooler`` (a dense) and tanh on ``[CLS]``; the sequence
classifier is ``classifier`` on the pooled row (``:837-888``).  Called
without token types, as the RM and the reranker call it, every token is in
segment 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch
from torch import nn

from lotus_tpu_torch.models.bert import ACTIVATIONS, BertEmbeddings, BertSelfAttention, EncoderConfig, mask_bias


@dataclass(frozen=True)
class AlbertConfig(EncoderConfig):
    """The fields of an ALBERT ``config.json`` the forward reads (the
    defaults are ``transformers``' ``AlbertConfig``'s)."""

    model_types: ClassVar[tuple[str, ...]] = ("albert",)
    vocab_size: int = 30000
    embedding_size: int = 128
    hidden_size: int = 4096
    num_hidden_layers: int = 12
    num_hidden_groups: int = 1
    num_attention_heads: int = 64
    intermediate_size: int = 16384
    inner_group_num: int = 1
    hidden_act: str = "gelu_new"
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    num_labels: int = 2


class AlbertAttention(BertSelfAttention):
    """BERT's self-attention with its output block in the same module:
    ``dense``, the residual and ``LayerNorm``."""

    def __init__(self, cfg: AlbertConfig):
        super().__init__(cfg)
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.dense(super().forward(x, bias)) + x)


class AlbertLayer(nn.Module):
    def __init__(self, cfg: AlbertConfig):
        super().__init__()
        self.attention = AlbertAttention(cfg)
        self.ffn = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.ffn_output = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.full_layer_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.act = ACTIVATIONS[cfg.hidden_act]

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = self.attention(x, bias)
        return self.full_layer_layer_norm(self.ffn_output(self.act(self.ffn(x))) + x)


class AlbertLayerGroup(nn.Module):
    def __init__(self, cfg: AlbertConfig):
        super().__init__()
        self.albert_layers = nn.ModuleList(AlbertLayer(cfg) for _ in range(cfg.inner_group_num))

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        for layer in self.albert_layers:
            x = layer(x, bias)
        return x


class AlbertTransformer(nn.Module):
    def __init__(self, cfg: AlbertConfig):
        super().__init__()
        self.config = cfg
        self.embedding_hidden_mapping_in = nn.Linear(cfg.embedding_size, cfg.hidden_size)
        self.albert_layer_groups = nn.ModuleList(AlbertLayerGroup(cfg) for _ in range(cfg.num_hidden_groups))

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = self.embedding_hidden_mapping_in(x)
        for i in range(cfg.num_hidden_layers):
            # The reference's float division: one group object serves every
            # layer it covers, so the parameters are shared, not copied.
            x = self.albert_layer_groups[int(i / (cfg.num_hidden_layers / cfg.num_hidden_groups))](x, bias)
        return x


class AlbertModel(nn.Module):
    """The encoder: ``forward`` gives the last hidden state (b, s, hidden).
    ``add_pooling_layer=False`` leaves out ``pooler``."""

    base_model_prefix = "albert"

    def __init__(self, cfg: AlbertConfig, add_pooling_layer: bool = True):
        super().__init__()
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg, cfg.embedding_size)
        self.encoder = AlbertTransformer(cfg)
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size) if add_pooling_layer else None

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: torch.Tensor | None = None) -> torch.Tensor:
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.embeddings(input_ids, token_type_ids)
        return self.encoder(x, mask_bias(attention_mask, x.dtype))

    def pool(self, hidden: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.pooler(hidden[:, 0]))


class AlbertForSequenceClassification(nn.Module):
    """The encoder, its pooler and ``classifier``: ``forward`` gives the
    logits (b, num_labels)."""

    base_model_prefix = "albert"

    def __init__(self, cfg: AlbertConfig):
        super().__init__()
        self.config = cfg
        self.albert = AlbertModel(cfg)
        self.classifier = nn.Linear(cfg.hidden_size, cfg.num_labels)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: torch.Tensor | None = None) -> torch.Tensor:
        return self.classifier(self.albert.pool(self.albert(input_ids, attention_mask, token_type_ids)))
