"""Byte-level BPE, RoBERTa's tokenizer model, without ``tokenizers`` or
``regex``.

The parts of the ``tokenizers`` library that ``RobertaTokenizerFast`` runs:

- the ``ByteLevel`` pre-tokenizer: GPT-2's pattern
  ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``
  splits the text, then each word's UTF-8 bytes map to printable characters
  (GPT-2's ``bytes_to_unicode``).  Python's ``re`` has no ``\\p{..}``, so the
  letter and number classes are built once from ``unicodedata``'s
  categories (``L*`` and ``N*``), and ``\\s`` is Unicode's White_Space
  property, as the library's regex engine reads it;
- the ``BPE`` model: a word's characters (with the continuing-subword prefix
  and end-of-word suffix where set) become ids; an unknown character becomes
  its UTF-8 bytes' ``<0xXX>`` tokens under ``byte_fallback`` (sentencepiece
  BPE: Llama, Mistral, Gemma) where the vocabulary holds all of them, else
  the unknown token (fused where ``fuse_unk``) or nothing; merges apply
  lowest rank first, leftmost first among equals, as the library's priority
  queue applies them.
"""

from __future__ import annotations

import json
import re
import sys
import unicodedata
from functools import lru_cache
from heapq import heappop, heappush

# Unicode's White_Space property: what \s matches in the tokenizers
# library's regex engine (Python's \s also takes U+001C-U+001F).
WHITE_SPACE = "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"


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


# str.translate table over a latin-1 decoded byte string: byte -> its character.
BYTE_TABLE = bytes_to_unicode()


def _class_ranges(prefixes: str) -> list[str]:
    """For each general-category letter in ``prefixes``, a regex
    character-class body of every code point whose category starts with it."""
    parts: list[list[str]] = [[] for _ in prefixes]
    open_at: list[int | None] = [None] * len(prefixes)
    for cp in range(sys.maxunicode + 2):
        cat = unicodedata.category(chr(cp))[0] if cp <= sys.maxunicode else ""
        for k, prefix in enumerate(prefixes):
            lo = open_at[k]
            if cat == prefix:
                if lo is None:
                    open_at[k] = cp
            elif lo is not None:
                parts[k].append(re.escape(chr(lo)) + ("" if cp - 1 == lo else "-" + re.escape(chr(cp - 1))))
                open_at[k] = None
    return ["".join(p) for p in parts]


@lru_cache(maxsize=None)
def byte_level_pattern() -> re.Pattern:
    """GPT-2's pre-tokenizer pattern with ``\\p{L}``, ``\\p{N}`` and ``\\s``
    spelled out (built on first use, in about a second)."""
    (letters, numbers), ws = _class_ranges("LN"), WHITE_SPACE
    return re.compile(
        rf"'s|'t|'re|'ve|'m|'ll|'d| ?[{letters}]+| ?[{numbers}]+| ?[^{ws}{letters}{numbers}]+"
        rf"|[{ws}]+(?![^{ws}])|[{ws}]+"
    )


_ASCII_WS = "\t\n\x0b\x0c\r "
# The same pattern over ASCII text, where \p{L} is A-Za-z and \p{N} 0-9: a
# third of the full pattern's time.
ASCII_PATTERN = re.compile(rf"'s|'t|'re|'ve|'m|'ll|'d| ?[A-Za-z]+| ?[0-9]+| ?[^{_ASCII_WS}A-Za-z0-9]+"
                           rf"|[{_ASCII_WS}]+(?![^{_ASCII_WS}])|[{_ASCII_WS}]+")


def byte_level_words(text: str, add_prefix_space: bool = False, use_regex: bool = True) -> list[str]:
    """The ``ByteLevel`` pre-tokenizer on one piece of text: words in
    GPT-2's byte characters."""
    if add_prefix_space and not text.startswith(" "):
        text = " " + text
    if not text.isascii():
        words = byte_level_pattern().findall(text) if use_regex else [text]
        return [w.encode("utf-8").decode("latin-1").translate(BYTE_TABLE) for w in words]
    # ASCII: one byte a character, so map the text once and cut it where the
    # pattern's words (which cover it end to end) cut it.
    mapped = text.translate(BYTE_TABLE)
    if not use_regex:
        return [mapped]
    out, at = [], 0
    for w in ASCII_PATTERN.findall(text):
        out.append(mapped[at : at + len(w)])
        at += len(w)
    return out


class BPE:
    """The ``BPE`` model over ``vocab`` (token -> id) and ``merges`` (pairs
    of tokens, by rank)."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]], *, unk_token: str | None = None,
                 continuing_subword_prefix: str | None = None, end_of_word_suffix: str | None = None,
                 fuse_unk: bool = False, byte_fallback: bool = False, ignore_merges: bool = False,
                 dropout: float | None = None):
        if dropout:
            raise NotImplementedError("BPE dropout: the port encodes deterministically")
        self.vocab = vocab
        self.unk_id = None if unk_token is None else vocab[unk_token]
        self.prefix = continuing_subword_prefix or ""
        self.suffix = end_of_word_suffix or ""
        self.fuse_unk = fuse_unk
        self.byte_fallback = byte_fallback
        self.ignore_merges = ignore_merges
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}  # (left, right) -> (rank, merged id)
        for rank, (a, b) in enumerate(merges):
            missing = [t for t in (a, b, a + b[len(self.prefix):]) if t not in vocab]
            if missing:
                raise ValueError(f"merge {a!r} {b!r}: {missing} not in the vocabulary")
            self.merges[vocab[a], vocab[b]] = (rank, vocab[a + b[len(self.prefix):]])

    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str, **kw) -> "BPE":
        """``vocab.json`` and ``merges.txt`` (a ``#version`` line, then one
        space-separated pair a line)."""
        with open(vocab_json, encoding="utf-8") as f:
            vocab = json.load(f)
        return cls(vocab, read_merges(merges_txt), **kw)

    def _symbols(self, word: str) -> list[int]:
        """The word's characters as ids, before any merge."""
        out: list[int] = []
        unk = None  # a pending unknown run
        last = len(word) - 1
        for i, c in enumerate(word):
            s = (self.prefix if i else "") + c + (self.suffix if i == last else "")
            got = self.vocab.get(s)
            if got is not None:
                if unk is not None:
                    out.append(unk)
                    unk = None
                out.append(got)
            elif self.byte_fallback and all(f"<0x{b:02X}>" in self.vocab for b in s.encode("utf-8")):
                # As the library does it: the bytes go in without flushing a
                # pending unknown run, which lands after them.
                out += [self.vocab[f"<0x{b:02X}>"] for b in s.encode("utf-8")]
            elif self.unk_id is not None:
                if unk is not None and not self.fuse_unk:
                    out.append(unk)
                unk = self.unk_id
        if unk is not None:
            out.append(unk)
        return out

    def _merge(self, ids: list[int]) -> list[int]:
        """Apply the merges: lowest rank first, then leftmost; a queued pair
        that no longer stands is skipped."""
        merges = self.merges
        n = len(ids)
        nxt = [*range(1, n), -1]
        prev = [-1, *range(n - 1)]
        alive = [True] * n
        queue: list[tuple[int, int, int]] = []
        for i in range(n - 1):
            m = merges.get((ids[i], ids[i + 1]))
            if m is not None:
                heappush(queue, (m[0], i, m[1]))
        while queue:
            _, pos, new_id = heappop(queue)
            right = nxt[pos]
            if not alive[pos] or right < 0:
                continue
            m = merges.get((ids[pos], ids[right]))
            if m is None or m[1] != new_id:
                continue
            ids[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[right] >= 0:
                prev[nxt[right]] = pos
            if prev[pos] >= 0:
                m = merges.get((ids[prev[pos]], new_id))
                if m is not None:
                    heappush(queue, (m[0], prev[pos], m[1]))
            if nxt[pos] >= 0:
                m = merges.get((new_id, ids[nxt[pos]]))
                if m is not None:
                    heappush(queue, (m[0], pos, m[1]))
        return [t for t, a in zip(ids, alive) if a]

    def __call__(self, word: str) -> list[int]:
        """The ids of one pre-tokenized word."""
        if not word:
            return []
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        return self._merge(self._symbols(word))


def read_merges(path: str) -> list[tuple[str, str]]:
    """The pairs of a ``merges.txt``, by rank."""
    with open(path, encoding="utf-8") as f:
        lines = f.read().split("\n")
    pairs = []
    for line in lines:
        if line.startswith("#version") or not line.strip():
            continue
        a, b = line.split(" ")
        pairs.append((a, b))
    return pairs

