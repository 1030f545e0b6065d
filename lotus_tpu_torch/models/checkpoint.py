"""BERT checkpoint directories without ``transformers`` or ``safetensors``.

A directory holds ``config.json`` and its weights in ``model.safetensors``
(read here: an 8-byte little-endian header length, a JSON header, raw
little-endian buffers) or ``pytorch_model.bin`` (``torch.load`` with
``weights_only=True``).  A directory with only ``flax_model.msgpack`` raises:
the port has no msgpack reader.  ``from_flax_params`` carries the JAX
package's parameters across as a state dict under Hugging Face's torch names.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any

import numpy as np
import torch
from torch import nn

from lotus_tpu_torch.models.bert import BertConfig, BertForSequenceClassification, BertModel

SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16, "I64": torch.int64}


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
    """The weights of a checkpoint directory, by their names in the file."""
    st = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(st):
        return read_safetensors(st)
    pt = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(pt):
        return torch.load(pt, map_location="cpu", weights_only=True)
    if os.path.exists(os.path.join(model_dir, "flax_model.msgpack")):
        raise NotImplementedError(f"{model_dir} holds only flax_model.msgpack; the port reads model.safetensors "
                                  f"or pytorch_model.bin")
    raise FileNotFoundError(f"{model_dir}: no model.safetensors or pytorch_model.bin")


def fit_state_dict(module: nn.Module, state: dict[str, torch.Tensor]) -> nn.Module:
    """Load ``state`` into a ``BertModel`` or ``BertForSequenceClassification``
    by name, with or without the ``bert.`` prefix.  Every parameter of the
    module must be present; weights it has no place for (an MLM head, a
    pooler the module leaves out, an old ``position_ids`` buffer) are
    ignored."""
    encoder_only = isinstance(module, BertModel)
    named = {}
    for name, t in state.items():
        bare = name[len("bert."):] if name.startswith("bert.") else name
        named[bare if encoder_only or bare.startswith("classifier.") else "bert." + bare] = t
    missing, _ = module.load_state_dict(named, strict=False)
    if missing:
        raise KeyError(f"the checkpoint lacks {missing}")
    return module


def load_bert(model_dir: str, classifier: bool = False) -> nn.Module:
    """The encoder (``BertModel`` without its pooler) or, with
    ``classifier``, ``BertForSequenceClassification`` of a checkpoint
    directory, in f32 on the CPU."""
    if not os.path.isdir(model_dir):
        raise FileNotFoundError(f"{model_dir!r} is not a checkpoint directory: the port reads local files and "
                                f"downloads nothing")
    cfg = BertConfig.from_dir(model_dir)
    module = BertForSequenceClassification(cfg) if classifier else BertModel(cfg, add_pooling_layer=False)
    return fit_state_dict(module, load_state_dict(model_dir)).eval()


def _flatten(tree: Any, prefix: tuple[str, ...] = ()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, (*prefix, str(k)))
    else:
        yield prefix, tree


def from_flax_params(params: dict, config: BertConfig) -> dict[str, torch.Tensor]:
    """The port's state dict from the nested parameters of a
    ``FlaxBertModel`` or ``FlaxBertForSequenceClassification`` (numpy
    arrays): a dense ``kernel`` (in, out) becomes ``weight`` (out, in), an
    ``embedding`` and a LayerNorm ``scale`` become ``weight``.  The names
    must be those of the port's module for ``config``."""
    out = {}
    for path, leaf in _flatten(params):
        *head, last = path
        t = torch.from_numpy(np.array(leaf, dtype=np.float32))
        if last == "kernel":
            last, t = "weight", t.T.contiguous()
        elif last in ("embedding", "scale"):
            last = "weight"
        out[".".join((*head, last))] = t
    with torch.device("meta"):
        ref = BertForSequenceClassification(config) if "classifier.weight" in out else BertModel(config)
    want = set(ref.state_dict())
    if set(out) != want:
        raise KeyError(f"Flax parameters do not map onto BERT: missing {sorted(want - set(out))}, "
                       f"unexpected {sorted(set(out) - want)}")
    return out
