"""Checkpoint directories of the encoder, encoder-decoder and decoder
families without ``transformers``, ``safetensors`` or ``msgpack``.

A directory holds ``config.json`` and its weights in ``model.safetensors``
(read here: an 8-byte little-endian header length, a JSON header, raw
little-endian buffers, one tensor read at a time), in the shards that
``model.safetensors.index.json`` names (as every published 7B checkpoint
is), ``pytorch_model.bin`` (``torch.load`` with ``weights_only=True``,
memory-mapped unless it is in the legacy pre-zip format), the shards of ``pytorch_model.bin.index.json`` or
``flax_model.msgpack`` (``msgpack.py``, its leaves renamed by
``flax_state_dict``), in that order (``iter_state_dict``).  The reference's
``from_pretrained`` reads all of these but sharded safetensors, on which
Flax raises ``NotImplementedError``; the port reads them.  ``FAMILIES`` maps each
``model_type`` the port runs to its config and modules; ``fit_state_dict``
loads any of the three by name, with or without the family's prefix
(``bert.``, ``roberta.``, ``distilbert.``, ``electra.``, ``albert.``,
``roformer.``, ``roberta_prelayernorm.``; BigBird's is ``bert.``, the
encoder-decoders' and Llama's, Mistral's, Gemma's, XGLM's, DeepSeek-V2's,
DeepSeek-V3.2's and Kimi-Linear's ``model.``, GPT-2's, GPT-Neo's, GPT-J's and BLOOM's ``transformer.``), and drops the heads the module has no place
for (a pretraining head, as most public Flax files carry: ``lm_head``,
``cls``, ``discriminator_predictions``, ALBERT's ``predictions`` and
``sop_classifier``; a ``*ForConditionalGeneration``'s ``lm_head`` and
``final_logits_bias``; a ``*ForCausalLM``'s ``lm_head``, old rotary
``inv_freq`` and causal-mask buffers; DeepSeek-V3.2's layers past those it
holds and its multi-token-prediction layer).  DeepSeek-V2's, DeepSeek-V3.2's
and Kimi-Linear's per-expert weights are stacked as they load (``deepseek_v2.GroupedExperts``).  The encoder-decoders' token embeddings are
``shared``: a checkpoint that carries ``encoder.embed_tokens`` /
``decoder.embed_tokens`` beside it or in its place loads as well
(``bart._tie_embeddings``; each must equal the one loaded).  The families' torch and
Flax names are the same modulo ``flax_state_dict``'s renames (ALBERT's
shared ``encoder.albert_layer_groups.<g>.albert_layers.<j>`` and
RoBERTa-PreLayerNorm's top-level ``LayerNorm`` included); RoFormer's
``encoder.embed_positions.weight``, which only torch files carry, is held to
the computed sinusoid table and not loaded, and so are Pegasus's two and
Marian's;
XGLM's ``embed_positions.weights``, which older torch files carry, is
ignored (Flax computes the table, ``xglm.py``).
"""

from __future__ import annotations

import json
import os
import struct
import zipfile
from typing import Any, Iterator

import numpy as np
import torch
from torch import nn

from lotus_tpu_torch.models.albert import AlbertConfig, AlbertForSequenceClassification, AlbertModel
from lotus_tpu_torch.models.bart import BartConfig, BartForSequenceClassification, BartModel
from lotus_tpu_torch.models.bert import BertConfig, BertForSequenceClassification, BertModel, EncoderConfig
from lotus_tpu_torch.models.big_bird import BigBirdConfig, BigBirdForSequenceClassification, BigBirdModel
from lotus_tpu_torch.models.blenderbot import BlenderbotConfig
from lotus_tpu_torch.models.blenderbot_small import BlenderbotSmallConfig, BlenderbotSmallModel
from lotus_tpu_torch.models.bloom import BloomConfig, BloomModel
from lotus_tpu_torch.models.deepseek_v2 import DeepseekV2Config, DeepseekV2Model
from lotus_tpu_torch.models.deepseek_v32 import DeepseekV32Config, DeepseekV32Model
from lotus_tpu_torch.models.distilbert import DistilBertConfig, DistilBertForSequenceClassification, DistilBertModel
from lotus_tpu_torch.models.electra import ElectraConfig, ElectraForSequenceClassification, ElectraModel
from lotus_tpu_torch.models.gemma import GemmaConfig
from lotus_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from lotus_tpu_torch.models.gpt_neo import GPTNeoConfig, GPTNeoModel
from lotus_tpu_torch.models.gptj import GPTJConfig, GPTJModel
from lotus_tpu_torch.models.kimi_linear import KimiLinearConfig, KimiLinearModel
from lotus_tpu_torch.models.llama import LlamaConfig, LlamaModel
from lotus_tpu_torch.models.marian import MarianConfig, MarianModel
from lotus_tpu_torch.models.mbart import MBartConfig, MBartForSequenceClassification, MBartModel
from lotus_tpu_torch.models.mistral import MistralConfig
from lotus_tpu_torch.models.msgpack import read_flax_msgpack
from lotus_tpu_torch.models.pegasus import PegasusConfig, PegasusModel
from lotus_tpu_torch.models.roberta import RobertaConfig, RobertaForSequenceClassification, RobertaModel
from lotus_tpu_torch.models.roberta_prelayernorm import (
    RobertaPreLayerNormConfig, RobertaPreLayerNormForSequenceClassification, RobertaPreLayerNormModel,
)
from lotus_tpu_torch.models.roformer import RoFormerConfig, RoFormerForSequenceClassification, RoFormerModel
from lotus_tpu_torch.models.xglm import XGLMConfig, XGLMModel

SAFETENSORS_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
                      "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
                      "BOOL": torch.bool}
# The weight files of a directory, in the order they are looked for.
WEIGHT_FILES = ("model.safetensors", "model.safetensors.index.json", "pytorch_model.bin",
                "pytorch_model.bin.index.json", "flax_model.msgpack")
# model_type -> (config, encoder, sequence classifier): the families
# FlaxAutoModel and FlaxAutoModelForSequenceClassification load that the
# port runs; None where the sequence-classification auto class does not map
# the type (an RM only).
FAMILIES: dict[str, tuple[type[EncoderConfig], type[nn.Module], type[nn.Module] | None]] = {
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
    "bart": (BartConfig, BartModel, BartForSequenceClassification),
    "mbart": (MBartConfig, MBartModel, MBartForSequenceClassification),
    "pegasus": (PegasusConfig, PegasusModel, None),
    "blenderbot": (BlenderbotConfig, BartModel, None),
    "blenderbot-small": (BlenderbotSmallConfig, BlenderbotSmallModel, None),
    "marian": (MarianConfig, MarianModel, None),
    "gpt2": (GPT2Config, GPT2Model, None),
    "gpt-sw3": (GPT2Config, GPT2Model, None),  # CONFIG_MAPPING_NAMES["gpt-sw3"] is GPT2Config
    "gpt_neo": (GPTNeoConfig, GPTNeoModel, None),
    "gptj": (GPTJConfig, GPTJModel, None),
    "llama": (LlamaConfig, LlamaModel, None),
    "mistral": (MistralConfig, LlamaModel, None),
    "gemma": (GemmaConfig, LlamaModel, None),
    "bloom": (BloomConfig, BloomModel, None),
    "xglm": (XGLMConfig, XGLMModel, None),
    "deepseek_v2": (DeepseekV2Config, DeepseekV2Model, None),
    "kimi_linear": (KimiLinearConfig, KimiLinearModel, None),
    "deepseek_v32": (DeepseekV32Config, DeepseekV32Model, None),
}
# What FlaxAutoModel maps that the port refuses, named in the refusal.
REFUSED = ("t5 and its kin (mt5, longt5)", "the vision and audio types")
# The encoders that carry a pooler unless told not to.
_POOLED = (BertModel, RobertaModel, AlbertModel, BigBirdModel, RobertaPreLayerNormModel)


def encoder_config(cfg: dict) -> EncoderConfig:
    """The family config of a parsed ``config.json``; a ``model_type`` the
    port does not run raises ``NotImplementedError`` naming it."""
    model_type = cfg.get("model_type", "bert")
    if model_type not in FAMILIES:
        raise NotImplementedError(f"model_type {model_type!r}: the port runs {', '.join(sorted(FAMILIES))} "
                                  f"checkpoints; of the other types FlaxAutoModel maps it refuses "
                                  f"{', '.join(REFUSED)}")
    return FAMILIES[model_type][0].from_dict(cfg)


def read_config(model_dir: str) -> EncoderConfig:
    with open(os.path.join(model_dir, "config.json"), encoding="utf-8") as f:
        return encoder_config(json.load(f))


def new_module(config: EncoderConfig, classifier: bool = False, pooler: bool = False) -> nn.Module:
    """The family's encoder (with a pooler where it has one and ``pooler``)
    or sequence classifier for ``config``, on the current default device."""
    model_type, encoder, seq_cls = next((t, *f[1:]) for t, f in FAMILIES.items() if f[0] is type(config))
    if classifier:
        if seq_cls is None:
            raise ValueError(f"model_type {model_type!r} has no sequence classifier: "
                             f"FlaxAutoModelForSequenceClassification does not map it, so the port runs it as an "
                             f"RM only")
        return seq_cls(config)
    return encoder(config, add_pooling_layer=pooler) if encoder in _POOLED else encoder(config)


def iter_safetensors(path: str) -> Iterator[tuple[str, torch.Tensor]]:
    """Each tensor of a ``.safetensors`` file, on the CPU, read from the file
    one at a time (each in a buffer of its own)."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        for name, entry in header.items():
            if name == "__metadata__":
                continue
            dtype = SAFETENSORS_DTYPES.get(entry["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: tensor {name!r} has dtype {entry['dtype']}; the reader takes "
                                 f"{sorted(SAFETENSORS_DTYPES)}")
            lo, hi = entry["data_offsets"]
            data = bytearray(hi - lo)
            f.seek(8 + header_len + lo)
            if f.readinto(data) != hi - lo:
                raise ValueError(f"{path}: tensor {name!r} runs past the end of the file")
            flat = torch.frombuffer(data, dtype=dtype) if data else torch.empty(0, dtype=dtype)
            yield name, flat.reshape(entry["shape"])


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU."""
    return dict(iter_safetensors(path))


def weight_files(model_dir: str) -> list[str]:
    """The weight files of a checkpoint directory: the first of
    WEIGHT_FILES it holds, or the shards its index names (in the order the
    index first names them)."""
    name = next((n for n in WEIGHT_FILES if os.path.exists(os.path.join(model_dir, n))), None)
    if name is None:
        raise FileNotFoundError(f"{model_dir}: no {', '.join(WEIGHT_FILES)}")
    if not name.endswith(".index.json"):
        return [os.path.join(model_dir, name)]
    with open(os.path.join(model_dir, name), encoding="utf-8") as f:
        shards = dict.fromkeys(json.load(f)["weight_map"].values())
    return [os.path.join(model_dir, shard) for shard in shards]


def iter_state_dict(model_dir: str) -> Iterator[tuple[str, torch.Tensor]]:
    """The weights of a checkpoint directory, one tensor at a time, by their
    names in the file (a Flax checkpoint's renamed as the port's,
    ``flax_state_dict``)."""
    for path in weight_files(model_dir):
        if path.endswith(".safetensors"):
            yield from iter_safetensors(path)
        elif path.endswith(".bin"):  # the legacy (pre-zip) format cannot be memory-mapped
            yield from torch.load(path, map_location="cpu", weights_only=True, mmap=zipfile.is_zipfile(path)).items()
        else:
            yield from flax_state_dict(read_flax_msgpack(path)).items()


def load_state_dict(model_dir: str) -> dict[str, torch.Tensor]:
    """The weights of a checkpoint directory on the CPU (``iter_state_dict``)."""
    return dict(iter_state_dict(model_dir))


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
    where they carry a ``classifier`` (``classification_head`` for the
    encoder-decoders), the sequence classifier."""
    out = flax_state_dict(params)
    with torch.device("meta"):
        ref = new_module(config, classifier=bool({"classifier", "classification_head"} & set(params)), pooler=True)
    want = set(ref.state_dict())
    if set(out) != want:
        raise KeyError(f"Flax parameters do not map onto {type(ref).__name__}: missing {sorted(want - set(out))}, "
                       f"unexpected {sorted(set(out) - want)}")
    return out
