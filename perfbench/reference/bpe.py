"""A plain byte-level BPE encoder for the seeded ``tokenizer.json`` of the
DeepSeek-V2 cell (``perfbench/bpe_files.py``), as ``LlamaTokenizerFast``
encodes with it: GPT-2's split of the text (for ASCII text: contractions,
letters, digits and other runs, each with the space before it, and runs of
whitespace), each piece's bytes as GPT-2's printable characters, the merges
applied lowest rank first (leftmost among equals), the BOS token before the
ids, truncated to ``max_length`` ids with the BOS counted.  Texts outside
ASCII are refused: the benchmark's texts are ASCII."""

from __future__ import annotations

import re

_SPLIT = re.compile(r"'s|'t|'re|'ve|'m|'ll|'d| ?[A-Za-z]+| ?[0-9]+| ?[^\sA-Za-z0-9]+|\s+(?!\S)|\s+")


def byte_chars() -> list[str]:
    """GPT-2's printable character of each byte value 0 .. 255."""
    printable = [*range(33, 127), *range(161, 173), *range(174, 256)]
    out, extra = {}, 0
    for b in range(256):
        if b in printable:
            out[b] = chr(b)
        else:
            out[b] = chr(256 + extra)
            extra += 1
    return [out[b] for b in range(256)]


class ByteBPE:
    def __init__(self, spec: dict, bos: str):
        model = spec["model"]
        self.vocab = dict(model["vocab"])
        self.vocab.update({t["content"]: t["id"] for t in spec.get("added_tokens", [])})
        self.ranks = {tuple(m if isinstance(m, list) else m.split(" ")): r for r, m in enumerate(model["merges"])}
        self.bos = self.vocab[bos]
        self.chars = byte_chars()
        self.memo: dict[str, list[int]] = {}

    def word(self, piece: str) -> list[int]:
        if piece not in self.memo:
            parts = [self.chars[b] for b in piece.encode("utf-8")]
            while len(parts) > 1:
                ranked = [(self.ranks.get((a, b), None), i) for i, (a, b) in enumerate(zip(parts, parts[1:]))]
                ranked = [x for x in ranked if x[0] is not None]
                if not ranked:
                    break
                _, i = min(ranked)
                parts[i : i + 2] = [parts[i] + parts[i + 1]]
            self.memo[piece] = [self.vocab[p] for p in parts]
        return self.memo[piece]

    def encode(self, text: str, max_length: int) -> list[int]:
        if not text.isascii():
            raise ValueError("the plain encoder reads ASCII text only")
        ids = [i for piece in _SPLIT.findall(text) for i in self.word(piece)]
        return [self.bos, *ids[: max_length - 1]]
