"""Checkpoint and tokenizer files written with nothing but torch, numpy and
the port, for the ``cuda``-marked tests: the card machine has no
``transformers``, ``tokenizers`` or ``protobuf``, so ``torch_families``'s
writers do not run there.

- ``seeded_words`` / ``seeded_docs``: a seeded lowercase vocabulary and
  texts of its words, whole words only (one WordPiece token a word);
- ``write_wordpiece``: ``vocab.txt`` (``[PAD]`` 0, ``[UNK]`` 1, ``[CLS]`` 2,
  ``[SEP]`` 3, ``[MASK]`` 4, the letters and their ``##`` forms, the words)
  and ``tokenizer_config.json``;
- ``write_checkpoint``: ``config.json`` and ``model.safetensors`` of a
  family's encoder or 1-label classifier as the port builds it, with
  seeded weights;
- ``spm_model_bytes`` / ``spm_pieces`` / ``spm_tokenizer_files``: a
  sentencepiece ``.model`` serialized by hand (a seeded Unigram that holds
  most words whole and splits the rest in two), and the tokenizer files of
  a seeded GPT-SW3 or Marian checkpoint.
"""

from __future__ import annotations

import json
import os
import string
import struct

import numpy as np
import torch

from lotus_tpu_torch.models.charsmap import build_charsmap
from lotus_tpu_torch.models.checkpoint import encoder_config, new_module

WORDPIECE_HEAD = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
# Full-width letters, circled digits, an ideographic space, a CJK
# compatibility character and a combining accent, as a charsmap maps them.
SMOKE_CHARSMAP = {
    **{chr(0xFF21 + i): chr(0x41 + i) for i in range(26)}, **{chr(0xFF41 + i): chr(0x61 + i) for i in range(26)},
    **{chr(0x2460 + i): str(i + 1) for i in range(9)}, "\u3000": " ", "\u337f": "\u682a\u5f0f\u4f1a\u793e",
    "e\u0301": "\u00e9",
}
WHOLE_SHARE = 0.7  # the share of words a seeded .model holds whole; the rest it holds as two halves


def seeded_words(seed: int, n: int) -> list[str]:
    """``n`` distinct seeded lowercase words of 3-10 letters."""
    rng = np.random.default_rng(seed)
    letters = np.array(list(string.ascii_lowercase))
    words: dict[str, None] = {}
    while len(words) < n:
        words.setdefault("".join(rng.choice(letters, int(rng.integers(3, 11)))))
    return list(words)


def seeded_docs(words: list[str], spans: list[tuple[int, int]], per_span: int, seed: int) -> list[str]:
    """``per_span`` texts of ``lo``-``hi`` words for each span, the words
    drawn from ``words``."""
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(words, int(rng.integers(lo, hi + 1)))) for lo, hi in spans for _ in range(per_span)]


def write_wordpiece(path: str, words: list[str]) -> int:
    """A lowercasing WordPiece ``vocab.txt`` over ``words``; returns its
    size."""
    os.makedirs(path, exist_ok=True)
    vocab = WORDPIECE_HEAD + list(string.ascii_lowercase) + ["##" + c for c in string.ascii_lowercase] + words
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    with open(os.path.join(path, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump({"do_lower_case": True, "tokenizer_class": "BertTokenizer"}, f)
    return len(vocab)


def write_safetensors(path: str, tensors: dict[str, torch.Tensor]) -> None:
    """f32 tensors as a ``.safetensors`` file (header padded to 8 bytes)."""
    header, offset = {}, 0
    for name, t in tensors.items():
        nbytes = t.numel() * 4
        header[name] = {"dtype": "F32", "shape": list(t.shape), "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw)
        for t in tensors.values():
            f.write(t.detach().float().contiguous().cpu().numpy().tobytes())


def write_checkpoint(path: str, config: dict, *, classifier: bool = False, seed: int = 0, std: float = 0.02) -> None:
    """``config.json`` and ``model.safetensors`` in ``path``: the family's
    encoder (or, with ``classifier``, its 1-label sequence classifier) as
    ``checkpoint.new_module`` builds it, every weight drawn from N(0,
    ``std``) but the norms' scales, drawn around 1 (around 0 where the
    family adds 1 to them, ``norm_offset``)."""
    os.makedirs(path, exist_ok=True)
    config = dict(config, **({"id2label": {"0": "LABEL_0"}} if classifier else {}))
    with open(os.path.join(path, "config.json"), "w", encoding="utf-8") as f:
        json.dump(config, f)
    family = encoder_config(config)
    module = new_module(family, classifier)
    g = torch.Generator().manual_seed(seed)
    around = 1.0 - getattr(family, "norm_offset", 0.0)
    with torch.no_grad():
        for name, p in sorted(module.named_parameters()):
            scale = name.endswith("weight") and any(n in name.lower() for n in ("norm", "ln_"))
            p.copy_((around if scale else 0.0) + std * torch.randn(p.shape, generator=g))
    write_safetensors(os.path.join(path, "model.safetensors"), module.state_dict())


def _pb_varint(v: int) -> bytes:
    v &= (1 << 64) - 1  # a negative int32 is its 64-bit two's complement, ten bytes
    out = bytearray()
    while True:
        if v < 0x80:
            return bytes(out + bytes([v]))
        out.append(v & 0x7F | 0x80)
        v >>= 7


def _pb_field(number: int, value) -> bytes:
    """One protobuf field: an int or bool as a varint, a float as fixed32,
    a str or bytes length-delimited."""
    if isinstance(value, float):
        return _pb_varint(number << 3 | 5) + struct.pack("<f", value)
    if isinstance(value, int):
        return _pb_varint(number << 3) + _pb_varint(int(value))
    raw = value.encode("utf-8") if isinstance(value, str) else bytes(value)
    return _pb_varint(number << 3 | 2) + _pb_varint(len(raw)) + raw


def spm_model_bytes(pieces: list[tuple[str, float, int]], *, model_type: int = 1, byte_fallback: bool = False,
                    unk_id: int = 0, bos_id: int = 1, eos_id: int = 2, pad_id: int = -1, charsmap: bytes = b"",
                    name: str = "identity", add_dummy_prefix: bool = True, remove_extra_whitespaces: bool = True,
                    escape_whitespaces: bool = True) -> bytes:
    """A sentencepiece ``.model`` file (a serialized ``ModelProto``, written
    without protobuf): ``pieces`` (piece, score, type) as field 1 (piece 1,
    score 2, type 3), ``trainer_spec`` 2 (model_type 3, byte_fallback 35,
    unk_id 40, bos_id 41, eos_id 42, pad_id 43) and ``normalizer_spec`` 3
    (name 1, precompiled_charsmap 2, add_dummy_prefix 3,
    remove_extra_whitespaces 4, escape_whitespaces 5)."""
    out = bytearray()
    for piece, score, kind in pieces:
        out += _pb_field(1, _pb_field(1, piece) + _pb_field(2, float(score)) + _pb_field(3, int(kind)))
    trainer = b"".join(_pb_field(n, v) for n, v in ((3, model_type), (35, byte_fallback), (40, unk_id),
                                                      (41, bos_id), (42, eos_id), (43, pad_id)))
    normalizer = _pb_field(1, name) + (_pb_field(2, charsmap) if charsmap else b"") + b"".join(
        _pb_field(n, v) for n, v in ((3, add_dummy_prefix), (4, remove_extra_whitespaces), (5, escape_whitespaces)))
    return bytes(out + _pb_field(2, trainer) + _pb_field(3, normalizer))


def spm_pieces(words: list[str], size: int, seed: int, head: list[tuple[str, int]],
               byte_fallback: bool = False) -> list[tuple[str, float, int]]:
    """A seeded Unigram vocabulary of ``size`` pieces: ``head`` (piece,
    type), the 256 ``<0xNN>`` BYTE pieces under ``byte_fallback``, then
    ``▁`` + each word for a WHOLE_SHARE of the words and ``▁`` + its first
    half and its second half for the rest (each piece scored -8 to -12, so
    a whole word beats any two pieces and a split one takes its two
    halves), single characters (-12 to -16), seeded fillers (-10 to -15)
    until ``size``; cut to ``size`` keeping every character."""
    rng = np.random.default_rng(seed)
    out = [(p, 0.0, kind) for p, kind in head] + ([(f"<0x{b:02X}>", 0.0, 6) for b in range(256)]
                                                 if byte_fallback else [])
    pieces: dict[str, float] = {}
    for w in words:
        if len(w) < 4 or rng.random() < WHOLE_SHARE:
            pieces.setdefault("▁" + w, -float(rng.uniform(8, 12)))
        else:
            half = len(w) // 2
            pieces.setdefault("▁" + w[:half], -float(rng.uniform(8, 12)))
            pieces.setdefault(w[half:], -float(rng.uniform(8, 12)))
    chars = {c: -float(rng.uniform(12, 16)) for c in string.ascii_letters + string.digits + string.punctuation
             + "▁éïüßÜ日本語中文株式会社" if c not in pieces}
    room = size - len(out) - len(chars)
    pieces = dict(list(pieces.items())[:room])
    letters = np.array(list(string.ascii_lowercase))
    while len(pieces) < room:
        filler = ("▁" if rng.random() < 0.5 else "") + "".join(rng.choice(letters, int(rng.integers(2, 8))))
        if filler not in chars:
            pieces.setdefault(filler, -float(rng.uniform(10, 15)))
    out += [(p, sc, 1) for p, sc in {**pieces, **chars}.items()]
    assert len(out) == size and len({p for p, _, _ in out}) == size
    return out


def spm_tokenizer_files(words: list[str], kind: str, size: int) -> dict:
    """The tokenizer files of a seeded GPT-SW3 or Marian checkpoint:
    GPT-SW3's ``spiece.model`` (``<unk> <pad> <s> <|endoftext|>``, the byte
    pieces, a Unigram with byte fallback, the identity normalizer keeping
    every space) and ``tokenizer_config.json`` naming ``GPTSw3Tokenizer``;
    or Marian's ``source.spm`` and ``target.spm`` (``<unk> <s> </s>``, a
    Unigram behind the seeded charsmap), ``vocab.json`` in opus-mt's layout
    (``</s>`` 0, ``<unk>`` 1, the pieces, ``<pad>`` last, ``size``
    entries) and ``tokenizer_config.json`` naming ``MarianTokenizer``."""
    if kind == "gpt-sw3":
        head = [("<unk>", 2), ("<pad>", 3), ("<s>", 3), ("<|endoftext|>", 3)]
        model = spm_model_bytes(spm_pieces(words, size, 80, head, byte_fallback=True), byte_fallback=True,
                                pad_id=1, bos_id=2, eos_id=3, remove_extra_whitespaces=False)
        return {"spiece.model": model,
                "tokenizer_config.json": {"tokenizer_class": "GPTSw3Tokenizer", "do_lower_case": False,
                                          "remove_space": False, "keep_accents": True, "bos_token": "<s>",
                                          "eos_token": "<|endoftext|>", "unk_token": "<unk>", "pad_token": "<pad>"}}
    pieces = spm_pieces(words, size, 81, [("<unk>", 2), ("<s>", 3), ("</s>", 3)])
    model = spm_model_bytes(pieces, charsmap=build_charsmap(SMOKE_CHARSMAP), name="nmt_nfkc")
    vocab = {"</s>": 0, "<unk>": 1}
    for p, _, _ in pieces:
        if p != "<s>":
            vocab.setdefault(p, len(vocab))
    vocab["<pad>"] = len(vocab)
    assert len(vocab) == size
    return {"source.spm": model, "target.spm": model, "vocab.json": vocab,
            "tokenizer_config.json": {"tokenizer_class": "MarianTokenizer", "source_lang": "en", "target_lang": "de"}}


def write_files(path: str, files: dict) -> None:
    """``spm_tokenizer_files``'s files in ``path``: bytes as they are, the
    rest as JSON."""
    os.makedirs(path, exist_ok=True)
    for name, obj in files.items():
        with open(os.path.join(path, name), "wb") as f:
            f.write(obj if isinstance(obj, bytes) else json.dumps(obj, ensure_ascii=False).encode("utf-8"))
