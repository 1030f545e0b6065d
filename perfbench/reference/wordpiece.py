"""A plain BERT tokenizer: the basic tokenizer (clean, CJK spacing,
lower-casing, accent stripping, punctuation splits) and WordPiece's greedy
longest-match-first, as ``BertTokenizer`` with ``do_lower_case`` does."""

from __future__ import annotations

import re
import unicodedata

_ASCII_CONTROL = re.compile(r"[\x00-\x08\x0b\x0c\x0e-\x1f\x7f]")
_ASCII_TOKENS = re.compile(r"[^\s!-/:-@\[-`{-~]+|[!-/:-@\[-`{-~]")


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF or 0xF900 <= cp <= 0xFAFF
            or 0x2F800 <= cp <= 0x2FA1F)


def basic_tokens(text: str) -> list[str]:
    if text.isascii():  # the same steps, for ASCII text, as two expressions
        return _ASCII_TOKENS.findall(_ASCII_CONTROL.sub("", text).lower())
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or (unicodedata.category(ch).startswith("C") and ch not in "\t\n\r"):
            continue
        if ch in " \t\n\r" or unicodedata.category(ch) == "Zs":
            out.append(" ")
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    tokens = []
    for word in "".join(out).split():
        word = "".join(c for c in unicodedata.normalize("NFD", word.lower()) if unicodedata.category(c) != "Mn")
        cur = ""
        for ch in word:
            if _is_punct(ch):
                if cur:
                    tokens.append(cur)
                tokens.append(ch)
                cur = ""
            else:
                cur += ch
        if cur:
            tokens.append(cur)
    return tokens


class WordPiece:
    def __init__(self, vocab: list[str], unk: str = "[UNK]", max_chars: int = 100):
        self.ids = {tok: i for i, tok in enumerate(vocab)}
        self.unk, self.max_chars = unk, max_chars
        self.memo: dict[str, list[int]] = {}

    def pieces(self, word: str) -> list[int]:
        if word not in self.memo:
            self.memo[word] = self._pieces(word)
        return self.memo[word]

    def _pieces(self, word: str) -> list[int]:
        if len(word) > self.max_chars:
            return [self.ids[self.unk]]
        out, start = [], 0
        while start < len(word):
            end, hit = len(word), None
            while start < end:
                sub = word[start:end] if start == 0 else "##" + word[start:end]
                if sub in self.ids:
                    hit = self.ids[sub]
                    break
                end -= 1
            if hit is None:
                return [self.ids[self.unk]]
            out.append(hit)
            start = end
        return out

    def encode(self, text: str, max_length: int = 512) -> list[int]:
        ids = [i for w in basic_tokens(text) for i in self.pieces(w)]
        return [self.ids["[CLS]"], *ids[: max_length - 2], self.ids["[SEP]"]]
