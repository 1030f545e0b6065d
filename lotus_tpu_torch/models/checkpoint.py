"""Checkpoint directories of the encoder families without ``transformers``,
``safetensors`` or ``msgpack``.

A directory holds ``config.json`` and its weights in ``model.safetensors``
(read here: an 8-byte little-endian header length, a JSON header, raw
little-endian buffers), ``pytorch_model.bin`` (``torch.load`` with
``weights_only=True``) or ``flax_model.msgpack`` (``msgpack.py``, its leaves
renamed by ``flax_state_dict``), in that order.  ``FAMILIES`` maps each
``model_type`` the port runs to its config and modules; ``fit_state_dict``
loads any of the three by name, with or without the family's prefix
(``bert.``, ``roberta.``, ``distilbert.``, ``electra.``, ``albert.``,
``roformer.``, ``roberta_prelayernorm.``; BigBird's is ``bert.``), and drops
the heads the module has no place for (a pretraining head, as most public
Flax files carry: ``lm_head``, ``cls``, ``discriminator_predictions``,
ALBERT's ``predictions`` and ``sop_classifier``).  The families' torch and
Flax names are the same modulo ``flax_state_dict``'s renames (ALBERT's
shared ``encoder.albert_layer_groups.<g>.albert_layers.<j>`` and
RoBERTa-PreLayerNorm's top-level ``LayerNorm`` included); RoFormer's
``encoder.embed_positions.weight``, which only torch files carry, is held to
the computed sinusoid table and not loaded.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any

import numpy as np
import torch
from torch import nn

from lotus_tpu_torch.models.albert import AlbertConfig, AlbertForSequenceClassification, AlbertModel
from lotus_tpu_torch.models.bert import BertConfig, BertForSequenceClassification, BertModel, EncoderConfig
from lotus_tpu_torch.models.big_bird import BigBirdConfig, BigBirdForSequenceClassification, BigBirdModel
from lotus_tpu_torch.models.distilbert import DistilBertConfig, DistilBertForSequenceClassification, DistilBertModel
from lotus_tpu_torch.models.electra import ElectraConfig, ElectraForSequenceClassification, ElectraModel
from lotus_tpu_torch.models.msgpack import read_flax_msgpack
from lotus_tpu_torch.models.roberta import RobertaConfig, RobertaForSequenceClassification, RobertaModel
from lotus_tpu_torch.models.roberta_prelayernorm import (
    RobertaPreLayerNormConfig, RobertaPreLayerNormForSequenceClassification, RobertaPreLayerNormModel,
)
from lotus_tpu_torch.models.roformer import RoFormerConfig, RoFormerForSequenceClassification, RoFormerModel

SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16, "I64": torch.int64}
# model_type -> (config, encoder, sequence classifier): the families
# FlaxAutoModel and FlaxAutoModelForSequenceClassification load that the
# port runs.
FAMILIES: dict[str, tuple[type[EncoderConfig], type[nn.Module], type[nn.Module]]] = {
    "bert": (BertConfig, BertModel, BertForSequenceClassification),
    "roberta": (RobertaConfig, RobertaModel, RobertaForSequenceClassification),
    "xlm-roberta": (RobertaConfig, RobertaModel, RobertaForSequenceClassification),
    "distilbert": (DistilBertConfig, DistilBertModel, DistilBertForSequenceClassification),
    "electra": (ElectraConfig, ElectraModel, ElectraForSequenceClassification),
    "albert": (AlbertConfig, AlbertModel, AlbertForSequenceClassification),
    "roformer": (RoFormerConfig, RoFormerModel, RoFormerForSequenceClassification),
    "big_bird": (BigBirdConfig, BigBirdModel, BigBirdForSequenceClassification),
    "roberta-prelayernorm": (RobertaPreLayerNormConfig, RobertaPreLayerNormModel,
                             RobertaPreLayerNormForSequenceClassification),
}
# The encoders that carry a pooler unless told not to.
_POOLED = (BertModel, RobertaModel, AlbertModel, BigBirdModel, RobertaPreLayerNormModel)


def encoder_config(cfg: dict) -> EncoderConfig:
    """The family config of a parsed ``config.json``; a ``model_type`` the
    port does not run raises ``NotImplementedError`` naming it."""
    model_type = cfg.get("model_type", "bert")
    if model_type not in FAMILIES:
        raise NotImplementedError(f"model_type {model_type!r}: the port runs {', '.join(sorted(FAMILIES))} "
                                  f"checkpoints")
    return FAMILIES[model_type][0].from_dict(cfg)


def read_config(model_dir: str) -> EncoderConfig:
    with open(os.path.join(model_dir, "config.json"), encoding="utf-8") as f:
        return encoder_config(json.load(f))


def new_module(config: EncoderConfig, classifier: bool = False, pooler: bool = False) -> nn.Module:
    """The family's encoder (with a pooler where it has one and ``pooler``)
    or sequence classifier for ``config``, on the current default device."""
    encoder, seq_cls = next(f[1:] for f in FAMILIES.values() if f[0] is type(config))
    if classifier:
        return seq_cls(config)
    return encoder(config, add_pooling_layer=pooler) if encoder in _POOLED else encoder(config)


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        data = bytearray(os.path.getsize(path) - 8 - header_len)
        f.readinto(data)
    out = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(entry["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {entry['dtype']}; the reader takes "
                             f"{sorted(SAFETENSORS_DTYPES)}")
        lo, hi = entry["data_offsets"]
        count = (hi - lo) // torch.empty((), dtype=dtype).element_size()
        flat = torch.frombuffer(data, dtype=dtype, count=count, offset=lo) if count else torch.empty(0, dtype=dtype)
        out[name] = flat.reshape(entry["shape"])
    return out


def load_state_dict(model_dir: str) -> dict[str, torch.Tensor]:
    """The weights of a checkpoint directory, by their names in the file
    (a Flax checkpoint's renamed as the port's, ``flax_state_dict``)."""
    st = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(st):
        return read_safetensors(st)
    pt = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(pt):
        return torch.load(pt, map_location="cpu", weights_only=True)
    fx = os.path.join(model_dir, "flax_model.msgpack")
    if os.path.exists(fx):
        return flax_state_dict(read_flax_msgpack(fx))
    raise FileNotFoundError(f"{model_dir}: no model.safetensors, pytorch_model.bin or flax_model.msgpack")


def fit_state_dict(module: nn.Module, state: dict[str, torch.Tensor]) -> nn.Module:
    """Load ``state`` into a family's encoder or sequence classifier by
    name, with or without the family's prefix.  Every parameter of the
    module must be present; weights it has no place for (an MLM head, a
    pooler the module leaves out, an old ``position_ids`` buffer, a learned
    position table where DistilBERT's is sinusoidal) are ignored (RoFormer's
    sinusoid table is checked as it loads, ``roformer.check_table``).  The
    module's parameters become ``state``'s tensors (so a module built on the
    meta device takes them without a copy)."""
    prefix = module.base_model_prefix + "."
    encoder_only = not hasattr(module, module.base_model_prefix)
    heads = {name for name, _ in module.named_children()} - {module.base_model_prefix}
    named = {}
    for name, t in state.items():
        bare = name[len(prefix):] if name.startswith(prefix) else name
        named[bare if encoder_only or bare.split(".", 1)[0] in heads else prefix + bare] = t
    missing, _ = module.load_state_dict(named, strict=False, assign=True)
    if missing:
        raise KeyError(f"the checkpoint lacks {missing}")
    return module


def _flatten(tree: Any, prefix: tuple[str, ...] = ()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, (*prefix, str(k)))
    else:
        yield prefix, tree


def flax_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """The nested parameters of a Flax model (numpy arrays) as a flat state
    dict under PyTorch's names: a dense ``kernel`` (in, out) becomes
    ``weight`` (out, in), an ``embedding`` and a LayerNorm ``scale`` become
    ``weight``; every other name stays."""
    out = {}
    for path, leaf in _flatten(params):
        *head, last = path
        t = torch.from_numpy(np.array(leaf, dtype=np.float32))
        if last == "kernel":
            last, t = "weight", t.T.contiguous()
        elif last in ("embedding", "scale"):
            last = "weight"
        out[".".join((*head, last))] = t
    return out


def from_flax_params(params: dict, config: EncoderConfig) -> dict[str, torch.Tensor]:
    """The port's state dict from the nested parameters of a Flax encoder
    or sequence classifier of ``config``'s family (``flax_state_dict``).
    The names must be exactly those of the port's module: the encoder (with
    its pooler, where the family has one, as Flax's encoders always do) or,
    where they carry a ``classifier``, the sequence classifier."""
    out = flax_state_dict(params)
    with torch.device("meta"):
        ref = new_module(config, classifier="classifier" in params, pooler=True)
    want = set(ref.state_dict())
    if set(out) != want:
        raise KeyError(f"Flax parameters do not map onto {type(ref).__name__}: missing {sorted(want - set(out))}, "
                       f"unexpected {sorted(set(out) - want)}")
    return out
