"""Seeded text, vocabulary and BERT weights for the e5-base-v2 cells, frozen
inside the benchmark.

``make_vocab`` and ``synth_texts`` are copied from ``chip_smoke.py``
(``smoke_vocab``, ``synth_texts``), ``write_safetensors`` from
``chip_smoke.py::write_bf16_safetensors``, and the weights follow
``chip_smoke.py::write_models`` (BERT's initialiser: N(0, 0.02), biases 0,
LayerNorm 1 / 0), drawn on the device in one call and rounded to the served
dtype, so the program and the reference get the same numbers.
"""

from __future__ import annotations

import json
import os
import string
import struct

import numpy as np
import torch

TOPIC_WORDS, ON_TOPIC = 4, 0.9


def make_vocab(seed: int, size: int) -> list[str]:
    """A seeded ``size``-entry WordPiece vocabulary in bert-base-uncased's
    layout: ``[PAD]``, ``[unused*]``, ``[UNK]`` ``[CLS]`` ``[SEP]``
    ``[MASK]`` at 100-103, single characters and their ``##`` forms, then
    seeded whole words (3-10 letters) and ``##`` pieces (2-4 letters)."""
    vocab = ["[PAD]", *(f"[unused{i}]" for i in range(99)), "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    chars = string.punctuation + string.digits + string.ascii_lowercase
    vocab += list(chars) + ["##" + c for c in string.digits + string.ascii_lowercase]
    rng = np.random.default_rng(seed)
    letters = np.array(list(string.ascii_lowercase))
    seen = set(vocab)
    while len(vocab) < size:
        piece = rng.random() < 0.15
        tok = ("##" if piece else "") + "".join(rng.choice(letters, rng.integers(2, 5) if piece else rng.integers(3, 11)))
        if tok not in seen:
            seen.add(tok)
            vocab.append(tok)
    return vocab


def synth_texts(vocab: list[str], n: int, lo: int, hi: int, seed: int, per_topic: int) -> list[str]:
    """``n`` seeded texts of ``lo``-``hi`` words on ``n // per_topic``
    topics, ``per_topic`` texts each (the same topics for the same ``n``,
    ``per_topic`` and lengths, whatever ``seed``).  A topic has one length,
    its texts within two words of it; a text draws each word with
    probability ON_TOPIC from its topic's TOPIC_WORDS, else from the whole
    vocabulary; one word in 20 is two words run together, which WordPiece
    splits into ``##`` pieces."""
    words = np.array([w for w in vocab if w.isalpha() and len(w) > 2 and not w.startswith("[")], dtype=object)
    topics = max(1, n // per_topic)
    topic_rng = np.random.default_rng(12345)
    topic_words = topic_rng.integers(0, len(words), (topics, TOPIC_WORDS))
    topic_len = topic_rng.integers(lo + 2, hi - 1, topics)
    rng = np.random.default_rng(seed)
    doc_topic = rng.permutation(n) % topics
    lengths = topic_len[doc_topic] + rng.integers(-2, 3, n)
    total = int(lengths.sum())
    topic = np.repeat(doc_topic, lengths)
    idx = np.where(rng.random(total) < ON_TOPIC, topic_words[topic, rng.integers(0, TOPIC_WORDS, total)],
                   rng.integers(0, len(words), total))
    flat = words[idx]
    joined = rng.random(total) < 0.05
    flat[joined] = flat[joined] + words[rng.integers(0, len(words), int(joined.sum()))]
    cuts = np.cumsum(lengths)[:-1]
    return [" ".join(ws).capitalize() + "." for ws in np.split(flat, cuts)]


def bert_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter of a BERT encoder with its pooler, by its
    checkpoint name (``nn.Linear`` weights are (out, in))."""
    h, f = cfg["hidden_size"], cfg["intermediate_size"]
    shapes = {
        "embeddings.word_embeddings.weight": (cfg["vocab_size"], h),
        "embeddings.position_embeddings.weight": (cfg["max_position_embeddings"], h),
        "embeddings.token_type_embeddings.weight": (cfg["type_vocab_size"], h),
        "embeddings.LayerNorm.weight": (h,), "embeddings.LayerNorm.bias": (h,),
    }
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key", "attention.self.value", "attention.output.dense"):
            shapes[p + name + ".weight"] = (h, h)
            shapes[p + name + ".bias"] = (h,)
        shapes[p + "attention.output.LayerNorm.weight"] = (h,)
        shapes[p + "attention.output.LayerNorm.bias"] = (h,)
        shapes[p + "intermediate.dense.weight"], shapes[p + "intermediate.dense.bias"] = (f, h), (f,)
        shapes[p + "output.dense.weight"], shapes[p + "output.dense.bias"] = (h, f), (h,)
        shapes[p + "output.LayerNorm.weight"], shapes[p + "output.LayerNorm.bias"] = (h,), (h,)
    shapes["pooler.dense.weight"], shapes["pooler.dense.bias"] = (h, h), (h,)
    return shapes


def bert_weights(cfg: dict, seed: int, device: torch.device, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """BERT's initialiser from ``seed``: every matrix from one N(0, 0.02)
    draw on ``device``, rounded to ``dtype``; biases 0, LayerNorm 1 / 0."""
    shapes = bert_shapes(cfg)
    mats = [n for n, s in shapes.items() if len(s) == 2]
    g = torch.Generator(device=device).manual_seed(seed)
    flat = (0.02 * torch.randn(sum(int(np.prod(shapes[n])) for n in mats), generator=g, device=device)).to(dtype)
    out, off = {}, 0
    for name, shape in shapes.items():
        if len(shape) == 2:
            size = int(np.prod(shape))
            out[name] = flat[off : off + size].view(shape)
            off += size
        else:
            fill = 1.0 if "LayerNorm" in name and name.endswith("weight") else 0.0
            out[name] = torch.full(shape, fill, dtype=dtype, device=device)
    return out


_ST_DTYPES = {torch.bfloat16: ("BF16", torch.int16), torch.float32: ("F32", torch.int32)}


def write_safetensors(path: str, tensors: dict[str, torch.Tensor]) -> None:
    """``tensors`` (one dtype, on any device) as a ``.safetensors`` file, one
    tensor at a time through the host (header padded to 8 bytes)."""
    header, offset = {}, 0
    for name, t in tensors.items():
        tag = _ST_DTYPES[t.dtype][0]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": tag, "shape": list(t.shape), "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw)
        for t in tensors.values():
            f.write(t.detach().contiguous().view(_ST_DTYPES[t.dtype][1]).cpu().numpy().data)


def write_model_dir(path: str, model_cfg: dict, vocab: list[str], weights: dict[str, torch.Tensor]) -> None:
    """A BERT checkpoint directory: ``config.json``, ``vocab.txt``,
    ``tokenizer_config.json`` and ``model.safetensors``."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(model_cfg, f)
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"do_lower_case": True, "tokenizer_class": "BertTokenizer"}, f)
    write_safetensors(os.path.join(path, "model.safetensors"), weights)
