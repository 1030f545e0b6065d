"""BERT as ``nn.Module``s: the encoder, its pooler and the sequence
classifier, under Hugging Face's parameter names.

The forward is Flax BERT's (``transformers/models/bert/modeling_flax_bert.py``),
which ``JaxSentenceEncoderRM`` and ``JaxCrossEncoderReranker`` run as XLA:
word + token-type + position embeddings and LayerNorm; per layer q/k/v, the
query scaled by 1/sqrt(head size) before the product, an additive mask bias
of ``finfo(dtype).min`` where the mask is 0, softmax, the output dense plus
the residual plus LayerNorm, the intermediate dense with ``hidden_act``
(``ACTIVATIONS``, Flax's ``ACT2FN``: ``gelu`` the exact erf form,
``gelu_new`` the tanh form), the output dense plus the residual plus
LayerNorm; the pooler's dense and tanh on ``[CLS]``; the classifier on the
pooled row.  Plain ``nn.Linear``, ``torch.matmul`` and ``softmax``: no
fused attention.

``EncoderConfig`` reads a ``config.json`` for every family; RoBERTa
(``roberta.py``), ELECTRA (``electra.py``), RoFormer (``roformer.py``) and
BigBird (``big_bird.py``) run these layers under their own embeddings,
attention and heads.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from functools import partial
from typing import ClassVar

import torch
import torch.nn.functional as F
from torch import nn

# Flax's ACT2FN for the activations the port runs: "gelu" is the exact erf
# form, "gelu_new" and "gelu_pytorch_tanh" (Gemma's) the tanh form
# (nn.gelu(approximate=True)); "relu" is Pegasus's, "silu" (x * sigmoid(x))
# Llama's and Mistral's, "swish" (the same function in ACT2FN) opus-mt's.
ACTIVATIONS = {"gelu": F.gelu, "gelu_new": partial(F.gelu, approximate="tanh"), "relu": F.relu,
               "gelu_pytorch_tanh": partial(F.gelu, approximate="tanh"), "silu": F.silu, "swish": F.silu}


class EncoderConfig:
    """What every family's config shares: it is read from ``config.json``,
    whose ``model_type`` must be one of ``model_types`` and whose activation
    (under ``activation_key``) one of ``ACTIVATIONS``; the dataclass fields
    are read under their own names, or under the names ``aliases`` maps to
    them (``transformers``' ``attribute_map``; the alias wins where both are
    set), and ``num_labels`` from ``id2label`` (or ``num_labels``, else the
    family's default)."""

    model_types: ClassVar[tuple[str, ...]] = ()
    activation_key: ClassVar[str] = "hidden_act"
    aliases: ClassVar[dict[str, str]] = {}

    @classmethod
    def from_dict(cls, cfg: dict):
        """Read a ``config.json``; another model type, an activation outside
        ``ACTIVATIONS`` or relative positions raise ``NotImplementedError``."""
        cfg = dict(cfg)
        for alias, name in cls.aliases.items():
            if cfg.get(alias) is not None:
                cfg[name] = cfg.pop(alias)
        model_type = cfg.get("model_type", cls.model_types[0])
        if model_type not in cls.model_types:
            raise NotImplementedError(f"model_type {model_type!r}: {cls.__name__} reads {', '.join(cls.model_types)}")
        field = cls.__dataclass_fields__.get(cls.activation_key)
        act = cfg.get(cls.activation_key, "gelu" if field is None else field.default)
        if act not in ACTIVATIONS:
            raise NotImplementedError(f"{cls.activation_key} {act!r}: the port runs {', '.join(map(repr, ACTIVATIONS))}")
        if cfg.get("position_embedding_type", "absolute") != "absolute":
            raise NotImplementedError(f"position_embedding_type {cfg['position_embedding_type']!r}: the port runs "
                                      f"'absolute' only")
        default = cls.__dataclass_fields__["num_labels"].default
        num_labels = len(cfg["id2label"]) if "id2label" in cfg else cfg.get("num_labels", default)
        fields = {k: cfg[k] for k in cls.__dataclass_fields__ if k in cfg and k != "num_labels"}
        return cls(**fields, num_labels=int(num_labels))

    @classmethod
    def from_dir(cls, path: str):
        with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
            return cls.from_dict(json.load(f))


@dataclass(frozen=True)
class BertConfig(EncoderConfig):
    """The fields of a BERT ``config.json`` the forward reads."""

    model_types: ClassVar[tuple[str, ...]] = ("bert",)

    vocab_size: int
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu"
    num_labels: int = 2


def mask_bias(attention_mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Flax BERT's additive bias, (b, 1, 1, s): 0 where the mask is set,
    ``finfo(dtype).min`` elsewhere."""
    bias = torch.zeros(attention_mask.shape, dtype=dtype, device=attention_mask.device)
    return bias.masked_fill(attention_mask == 0, torch.finfo(dtype).min)[:, None, None, :]


class BertEmbeddings(nn.Module):
    """Word + token-type + position embeddings and LayerNorm, ``width``
    wide (the hidden size, or ELECTRA's ``embedding_size``)."""

    def __init__(self, cfg: BertConfig, width: int | None = None):
        super().__init__()
        width = width or cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, width)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, width)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, width)
        self.LayerNorm = nn.LayerNorm(width, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor, token_type_ids: torch.Tensor,
                positions: torch.Tensor | None = None) -> torch.Tensor:
        """``positions`` (b, s) default to 0, 1, ... in every row."""
        if positions is None:
            positions = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = self.word_embeddings(input_ids) + self.token_type_embeddings(token_type_ids)
        return self.LayerNorm(x + self.position_embeddings(positions))


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, bias: bool = True):
        super().__init__()
        self.heads = cfg.num_attention_heads
        self.query = nn.Linear(cfg.hidden_size, cfg.hidden_size, bias=bias)
        self.key = nn.Linear(cfg.hidden_size, cfg.hidden_size, bias=bias)
        self.value = nn.Linear(cfg.hidden_size, cfg.hidden_size, bias=bias)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        q, k, v = self.heads_of(x)
        return self.merge(self.attend(q, k, v, bias))

    def heads_of(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """q, k, v of ``x`` (b, s, h), each (b, heads, s, head size)."""
        b, s, h = x.shape
        return tuple(t(x).view(b, s, self.heads, h // self.heads).transpose(1, 2)
                     for t in (self.query, self.key, self.value))

    @staticmethod
    def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        scores = torch.matmul(q / math.sqrt(q.shape[-1]), k.transpose(-1, -2)) + bias
        return torch.matmul(torch.softmax(scores, dim=-1), v)

    @staticmethod
    def merge(ctx: torch.Tensor) -> torch.Tensor:
        """(b, heads, s, head size) -> (b, s, h)."""
        b, heads, s, d = ctx.shape
        return ctx.transpose(1, 2).reshape(b, s, heads * d)


class BertSelfOutput(nn.Module):
    def __init__(self, cfg: BertConfig, width: int):
        super().__init__()
        self.dense = nn.Linear(width, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.dense(x) + residual)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig, attention: type[nn.Module] = BertSelfAttention):
        super().__init__()
        self.self = attention(cfg)
        self.output = BertSelfOutput(cfg, cfg.hidden_size)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return self.output(self.self(x, bias), x)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.act = ACTIVATIONS[cfg.hidden_act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.dense(x))


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, attention: type[nn.Module] = BertSelfAttention):
        super().__init__()
        self.attention = BertAttention(cfg, attention)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertSelfOutput(cfg, cfg.intermediate_size)  # HF's BertOutput: the same shape of block

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = self.attention(x, bias)
        return self.output(self.intermediate(x), x)


class BertEncoder(nn.Module):
    """The layers; ``attention`` is the self-attention module of each
    (BERT's, or a family's that reads other inputs: ``bias`` is handed to
    it as the family's encoder gives it)."""

    def __init__(self, cfg: BertConfig, attention: type[nn.Module] = BertSelfAttention):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg, attention) for _ in range(cfg.num_hidden_layers))

    def forward(self, x: torch.Tensor, bias) -> torch.Tensor:
        for layer in self.layer:
            x = layer(x, bias)
        return x


class BertPooler(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(hidden[:, 0]))


class BertModel(nn.Module):
    """The encoder: ``forward`` gives the last hidden state (b, s, hidden).
    ``add_pooling_layer=False`` leaves out the pooler (an embedding model
    does not read it, and some checkpoints do not carry it)."""

    base_model_prefix = "bert"
    embeddings_cls = BertEmbeddings
    encoder_cls = BertEncoder
    absent_token_type = 0  # the segment Flax gives every token when the caller passes no token_type_ids

    def __init__(self, cfg: BertConfig, add_pooling_layer: bool = True):
        super().__init__()
        self.config = cfg
        self.embeddings = self.embeddings_cls(cfg)
        self.encoder = self.encoder_cls(cfg)
        self.pooler = BertPooler(cfg) if add_pooling_layer else None

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: torch.Tensor | None = None) -> torch.Tensor:
        if token_type_ids is None:
            token_type_ids = torch.full_like(input_ids, self.absent_token_type)
        x = self.embed(input_ids, token_type_ids)
        return self.encoder(x, self.attention_input(attention_mask, x.dtype))

    def embed(self, input_ids: torch.Tensor, token_type_ids: torch.Tensor) -> torch.Tensor:
        return self.embeddings(input_ids, token_type_ids)

    def attention_input(self, attention_mask: torch.Tensor, dtype: torch.dtype):
        """What the encoder hands each layer's self-attention: Flax's
        additive mask bias."""
        return mask_bias(attention_mask, dtype)


class BertForSequenceClassification(nn.Module):
    """The encoder, its pooler and ``classifier``: ``forward`` gives the
    logits (b, num_labels)."""

    base_model_prefix = "bert"

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        self.bert = BertModel(cfg)
        self.classifier = nn.Linear(cfg.hidden_size, cfg.num_labels)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: torch.Tensor | None = None) -> torch.Tensor:
        return self.classifier(self.bert.pooler(self.bert(input_ids, attention_mask, token_type_ids)))
