"""The seeded byte-level BPE tokenizer of the DeepSeek-V2 cell, frozen inside
the benchmark.

``bpe_spec`` is copied from ``chip_smoke.py::bpe_spec`` (its ``roberta``
flavor's vocabulary and merges) with DeepSeek-V2's specials in place of
RoBERTa's: the 256 byte characters, then the merges that build ``Ġ`` + each
word left to right (then the bare words) until the vocabulary holds
``size`` - 2 entries, then BOS and EOS.  ``write_tokenizer_dir`` writes it
as DeepSeek-V2-Lite's tokenizer files are laid out: ``LlamaTokenizerFast``
with ``add_bos_token`` true and ``add_eos_token`` false (BOS before every
text); EOS is the pad token and pads on the right (both assumed: the
published file names no pad token).
"""

from __future__ import annotations

import json
import os

BOS, EOS = "<｜begin▁of▁sentence｜>", "<｜end▁of▁sentence｜>"


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's map of the 256 byte values to printable characters."""
    bs = [*range(ord("!"), ord("~") + 1), *range(ord("¡"), ord("¬") + 1), *range(ord("®"), ord("ÿ") + 1)]
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def bpe_spec(words: list[str], size: int) -> dict:
    """A ``tokenizer.json`` of ``size`` entries (ids ``size`` - 2 and - 1 are
    BOS and EOS)."""
    vocab = {c: i for i, c in enumerate(bytes_to_unicode().values())}
    merges = []
    for form in ["Ġ" + w for w in words] + list(words):
        for k in range(1, len(form)):
            if len(vocab) >= size - 2:
                break
            if form[: k + 1] not in vocab:
                merges.append([form[:k], form[k]])
                vocab[form[: k + 1]] = len(vocab)
    if len(vocab) != size - 2:
        raise ValueError(f"{len(words)} words fill {len(vocab)} of the vocabulary's {size - 2} entries")

    def bos(type_id: int) -> dict:
        return {"SpecialToken": {"id": BOS, "type_id": type_id}}

    def seq(part: str, type_id: int) -> dict:
        return {"Sequence": {"id": part, "type_id": type_id}}

    added = [{"id": size - 2 + i, "content": t, "single_word": False, "lstrip": False, "rstrip": False,
              "normalized": False, "special": True} for i, t in enumerate((BOS, EOS))]
    return {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added, "normalizer": None,
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True, "use_regex": True},
        "post_processor": {"type": "TemplateProcessing", "single": [bos(0), seq("A", 0)],
                           "pair": [bos(0), seq("A", 0), bos(1), seq("B", 1)],
                           "special_tokens": {BOS: {"id": BOS, "ids": [size - 2], "tokens": [BOS]}}},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None, "continuing_subword_prefix": "",
                  "end_of_word_suffix": "", "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                  "vocab": vocab, "merges": merges},
    }


def write_tokenizer_dir(path: str, spec: dict, model_cfg: dict) -> None:
    """``tokenizer.json``, ``tokenizer_config.json`` and ``config.json`` (the
    model's) in ``path``."""
    os.makedirs(path, exist_ok=True)
    config = {"tokenizer_class": "LlamaTokenizerFast", "add_bos_token": True, "add_eos_token": False,
              "bos_token": BOS, "eos_token": EOS, "pad_token": EOS, "padding_side": "right",
              "model_max_length": 16384}
    for name, obj in (("tokenizer.json", spec), ("tokenizer_config.json", config), ("config.json", model_cfg)):
        with open(os.path.join(path, name), "w", encoding="utf-8") as f:
            json.dump(obj, f, ensure_ascii=False)
