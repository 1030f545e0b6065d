"""BERT's WordPiece tokenizer, read from a checkpoint directory.

The counterpart of what ``AutoTokenizer`` gives a BERT checkpoint in
``lotus_tpu/models/flax_rm.py:110-118`` and ``flax_reranker.py:87-95``
(``BertTokenizerFast``: the ``tokenizers`` library's ``BertNormalizer``,
``BertPreTokenizer``, ``WordPiece`` model and ``[CLS] A [SEP] B [SEP]``
template), with the same ids, so the port needs neither ``transformers``
nor ``tokenizers``.  In order:

1. special tokens written in the text (``[SEP]``, ...) are split out first,
   as the fast tokenizer's added vocabulary does;
2. the normalizer drops NUL, U+FFFD and control characters (tab, newline
   and carriage return count as whitespace), maps whitespace to a space,
   puts spaces around CJK ideographs, strips accents (NFD, then no
   non-spacing marks) and lower-cases char by char (no final sigma);
3. the pre-tokenizer splits on whitespace and isolates each punctuation
   character (ASCII punctuation and the Unicode ``P*`` categories);
4. WordPiece: greedy longest match from the left with ``##`` continuations;
   a word with no full split, or longer than 100 characters, is ``[UNK]``.

A whitespace-separated word's piece ids are memoised, so a word met again
costs one dict lookup.  Encodings are int64 numpy arrays.  Character classes
come from Python's ``unicodedata``; about 500 code points that Unicode
assigned after the tables of the ``tokenizers`` library (0.22) may be
normalised differently.
"""

from __future__ import annotations

import json
import os
import re
import unicodedata
from typing import Iterator, Sequence

import numpy as np

MAX_WORD_CHARS = 100  # WordPiece's max_input_chars_per_word
MEMO_LIMIT = 1 << 20  # words memoised before the memo starts over
_SPECIAL_KEYS = ("unk_token", "sep_token", "pad_token", "cls_token", "mask_token")
_DEFAULT_SPECIALS = {"unk_token": "[UNK]", "sep_token": "[SEP]", "pad_token": "[PAD]",
                     "cls_token": "[CLS]", "mask_token": "[MASK]"}
# ASCII control characters dropped; tab, newline and carriage return become spaces.
_ASCII_CONTROL = {i: " " if i in (9, 10, 13) else None for i in [*range(32), 127]}
_CJK = re.compile("([\u4e00-\u9fff\u3400-\u4dbf\U00020000-\U0002a6df\U0002a700-\U0002b73f"
                  "\U0002b740-\U0002b81f\U0002b920-\U0002ceaf\uf900-\ufaff\U0002f800-\U0002fa1f])")
_NON_ASCII = re.compile(r"[^\x00-\x7f]")
_ASCII_PUNCT = frozenset("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")


def _is_control(c: str) -> bool:
    return c not in "\t\n\r" and unicodedata.category(c) in ("Cc", "Cf", "Co", "Cs")


def _clean_char(m: re.Match) -> str:
    """A non-ASCII character cleaned: controls and U+FFFD dropped,
    whitespace made a space."""
    c = m.group()
    if c == "\ufffd" or _is_control(c):
        return ""
    return " " if c.isspace() else c


def _drop_nonspacing_mark(m: re.Match) -> str:
    c = m.group()
    return "" if unicodedata.category(c) == "Mn" else c


def _is_punct(c: str) -> bool:
    return c in _ASCII_PUNCT or unicodedata.category(c).startswith("P")


def _special_token(value) -> str:
    """A special token as ``tokenizer_config.json`` writes it: a string or an
    added-token dict."""
    return value["content"] if isinstance(value, dict) else str(value)


class WordPieceTokenizer:
    """BERT's tokenizer over ``vocab`` (token -> id, the line number in
    ``vocab.txt``)."""

    def __init__(self, vocab: dict[str, int], *, do_lower_case: bool = True, strip_accents: bool | None = None,
                 tokenize_chinese_chars: bool = True, specials: dict[str, str] | None = None):
        self.vocab = vocab
        self.do_lower_case = do_lower_case
        # None follows do_lower_case, as BertNormalizer's strip_accents does.
        self.strip_accents = do_lower_case if strip_accents is None else strip_accents
        self.tokenize_chinese_chars = tokenize_chinese_chars
        names = {**_DEFAULT_SPECIALS, **(specials or {})}
        missing = [names[k] for k in _SPECIAL_KEYS if names[k] not in vocab]
        if missing:
            raise KeyError(f"special tokens {missing} are not in the vocabulary")
        self.unk_id, self.sep_id, self.pad_id, self.cls_id, _ = (vocab[names[k]] for k in _SPECIAL_KEYS)
        self._special_ids = {names[k]: vocab[names[k]] for k in _SPECIAL_KEYS}
        alternatives = sorted(self._special_ids, key=len, reverse=True)  # leftmost-longest
        self._special_re = re.compile("(" + "|".join(map(re.escape, alternatives)) + ")")
        self._memo: dict[str, list[int]] = {}

    @classmethod
    def from_dir(cls, path: str) -> "WordPieceTokenizer":
        """``vocab.txt`` and, where present, ``tokenizer_config.json``
        (``do_lower_case``, ``strip_accents``, ``tokenize_chinese_chars`` and
        the special tokens)."""
        vocab: dict[str, int] = {}
        with open(os.path.join(path, "vocab.txt"), encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        cfg: dict = {}
        cfg_path = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                cfg = json.load(f)
        return cls(vocab, do_lower_case=cfg.get("do_lower_case", True), strip_accents=cfg.get("strip_accents"),
                   tokenize_chinese_chars=cfg.get("tokenize_chinese_chars", True),
                   specials={k: _special_token(cfg[k]) for k in _SPECIAL_KEYS if cfg.get(k) is not None})

    # ---- text -> piece ids -------------------------------------------------

    def _normalize(self, text: str) -> str:
        text = text.translate(_ASCII_CONTROL)
        if not text.isascii():
            text = _NON_ASCII.sub(_clean_char, text)
            if self.tokenize_chinese_chars:
                text = _CJK.sub(r" \1 ", text)
            if self.strip_accents:
                text = _NON_ASCII.sub(_drop_nonspacing_mark, unicodedata.normalize("NFD", text))
        if self.do_lower_case:
            # Char by char, as the tokenizers library lowers: str.lower() would
            # give a word-final capital sigma its final form.
            text = "".join(c.lower() for c in text) if "\u03a3" in text else text.lower()
        return text

    def _word_ids(self, word: str) -> list[int]:
        """Piece ids of one whitespace-separated word: punctuation isolated,
        then greedy longest-match WordPiece on each part."""
        if word.isalnum():
            parts = [word]
        else:
            parts, cur = [], ""
            for c in word:
                if _is_punct(c):
                    parts += [cur, c] if cur else [c]
                    cur = ""
                else:
                    cur += c
            if cur:
                parts.append(cur)
        ids: list[int] = []
        for part in parts:
            if len(part) > MAX_WORD_CHARS:
                ids.append(self.unk_id)
                continue
            pieces, start = [], 0
            while start < len(part):
                end = len(part)
                while end > start:
                    piece = self.vocab.get(part[start:end] if start == 0 else "##" + part[start:end])
                    if piece is not None:
                        break
                    end -= 1
                else:
                    pieces = [self.unk_id]
                    break
                pieces.append(piece)
                start = end
            ids += pieces
        return ids

    def tokenize(self, text: str) -> list[int]:
        """Piece ids of ``text``, without ``[CLS]`` / ``[SEP]``."""
        ids: list[int] = []
        memo = self._memo
        for i, seg in enumerate(self._special_re.split(text)):
            if i % 2:  # a special token written in the text
                ids.append(self._special_ids[seg])
                continue
            for word in self._normalize(seg).split():
                got = memo.get(word)
                if got is None:
                    if len(memo) >= MEMO_LIMIT:
                        memo.clear()
                    got = memo[word] = self._word_ids(word)
                ids += got
        return ids

    # ---- sequences ---------------------------------------------------------

    def _encode(self, texts: Sequence[str], text_pair: Sequence[str] | None,
                max_length: int | None) -> Iterator[tuple[list[int], int]]:
        """(ids, first) per text: the ids with ``[CLS]`` / ``[SEP]``, a pair
        cut ``longest_first`` to ``max_length``, and the length of
        ``[CLS] A [SEP]``, where a pair's second token type begins."""
        for j, text in enumerate(texts):
            a = self.tokenize(text)
            if text_pair is None:
                if max_length is not None:
                    a = a[: self._room(max_length, 2)]
                yield [self.cls_id, *a, self.sep_id], len(a) + 2
                continue
            b = self.tokenize(text_pair[j])
            if max_length is not None:
                a, b = self._longest_first(a, b, self._room(max_length, 3))
            yield [self.cls_id, *a, self.sep_id, *b, self.sep_id], len(a) + 2

    def encode(self, texts: Sequence[str], text_pair: Sequence[str] | None = None,
               max_length: int | None = None) -> list[list[int]]:
        """The ids of each text (or pair), with ``[CLS]`` / ``[SEP]``; a pair
        is cut ``longest_first`` to ``max_length``."""
        return [ids for ids, _ in self._encode(texts, text_pair, max_length)]

    @staticmethod
    def _room(max_length: int, added: int) -> int:
        if max_length < added:
            raise ValueError(f"max_length {max_length} leaves no room beside {added} special tokens")
        return max_length - added

    @staticmethod
    def _longest_first(a: list[int], b: list[int], room: int) -> tuple[list[int], list[int]]:
        """The ``tokenizers`` library's ``longest_first``: the shorter
        sequence keeps its length where the longer can take the rest, else
        each keeps half (the longer one the odd token)."""
        if len(a) + len(b) <= room:
            return a, b
        n1, n2 = sorted((len(a), len(b)))
        n2 = n1 if n1 > room else max(n1, room - n1)
        if n1 + n2 > room:
            n1, n2 = room // 2, room // 2 + room % 2
        if len(a) > len(b):
            n1, n2 = n2, n1
        return a[:n1], b[:n2]

    def pad(self, encoded: list[list[int]], length: int) -> tuple[np.ndarray, np.ndarray]:
        """``(input_ids, attention_mask)``, each (len(encoded), length)
        int64, padded on the right."""
        n = len(encoded)
        ids = np.full((n, length), self.pad_id, np.int64)
        mask = np.zeros((n, length), np.int64)
        for r, a in enumerate(encoded):
            ids[r, : len(a)] = a
            mask[r, : len(a)] = 1
        return ids, mask

    def __call__(self, texts: Sequence[str], text_pair: Sequence[str] | None = None, *,
                 max_length: int | None = None, padding: bool | str = True) -> dict[str, np.ndarray]:
        """Encode a batch as ``tokenizer(texts, text_pair, truncation=True,
        max_length=..., padding=...)`` does: ``padding=True`` pads to the
        longest, ``"max_length"`` to ``max_length``; with
        ``token_type_ids``, 1 on a pair's second segment."""
        rows = list(self._encode(texts, text_pair, max_length))
        if padding == "max_length":
            if max_length is None:
                raise ValueError('padding="max_length" needs max_length')
            length = max_length
        elif padding is True:
            length = max((len(a) for a, _ in rows), default=0)
        else:
            raise ValueError(f"padding must be True or 'max_length', got {padding!r}")
        ids, mask = self.pad([a for a, _ in rows], length)
        types = np.zeros_like(ids)
        if text_pair is not None:
            for r, (a, first) in enumerate(rows):
                types[r, first : len(a)] = 1
        return {"input_ids": ids, "token_type_ids": types, "attention_mask": mask}
