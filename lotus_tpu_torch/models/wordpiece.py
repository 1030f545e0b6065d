"""BERT's WordPiece tokenizer: its normalizer, pre-tokenizer and model, and
the reader for a checkpoint directory that holds only ``vocab.txt``.

The counterpart of what ``AutoTokenizer`` gives a BERT checkpoint in
``lotus_tpu/models/flax_rm.py:110-118`` and ``flax_reranker.py:87-95``
(``BertTokenizerFast``: the ``tokenizers`` library's ``BertNormalizer``,
``BertPreTokenizer``, ``WordPiece`` model and ``[CLS] A [SEP] B [SEP]``
template), with the same ids, so the port needs neither ``transformers``
nor ``tokenizers``.  In order:

1. special tokens written in the text (``[SEP]``, ...) are split out first,
   as the fast tokenizer's added vocabulary does;
2. the normalizer (``bert_normalize``) drops NUL, U+FFFD and control
   characters (tab, newline and carriage return count as whitespace), maps
   whitespace to a space, puts spaces around CJK ideographs, strips accents
   (NFD, then no non-spacing marks) and lower-cases char by char (no final
   sigma);
3. the pre-tokenizer splits on whitespace and isolates each punctuation
   character (``split_punctuation``: ASCII punctuation and the Unicode
   ``P*`` categories);
4. WordPiece (``wordpiece``): greedy longest match from the left with
   ``##`` continuations; a word with no full split, or longer than 100
   characters, is ``[UNK]``.

``tokenizer_json.JsonTokenizer`` runs these functions for a WordPiece
``tokenizer.json``, and ``WordPieceTokenizer.from_dir`` gives the same
tokenizer for a ``vocab.txt``.  Character classes come from Python's
``unicodedata``; about 500 code points that Unicode assigned after the
tables of the ``tokenizers`` library (0.22) may be normalised differently.
"""

from __future__ import annotations

import re
import unicodedata

MAX_WORD_CHARS = 100  # WordPiece's max_input_chars_per_word
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


def lowercase(text: str) -> str:
    """Lower-cased char by char, as the tokenizers library lowers:
    ``str.lower()`` would give a word-final capital sigma its final form."""
    return "".join(c.lower() for c in text) if "\u03a3" in text else text.lower()


def bert_normalize(text: str, *, clean_text: bool = True, handle_chinese_chars: bool = True,
                   strip_accents: bool = True, lowercase_text: bool = True) -> str:
    """The tokenizers library's ``BertNormalizer``."""
    if clean_text:
        text = text.translate(_ASCII_CONTROL)
    if not text.isascii():
        if clean_text:
            text = _NON_ASCII.sub(_clean_char, text)
        if handle_chinese_chars:
            text = _CJK.sub(r" \1 ", text)
        if strip_accents:
            text = _NON_ASCII.sub(_drop_nonspacing_mark, unicodedata.normalize("NFD", text))
    return lowercase(text) if lowercase_text else text


def split_punctuation(word: str) -> list[str]:
    """``word`` with each punctuation character split out on its own, as
    ``BertPreTokenizer`` splits a whitespace-separated word."""
    if word.isalnum():
        return [word]
    parts, cur = [], ""
    for c in word:
        if _is_punct(c):
            parts += [cur, c] if cur else [c]
            cur = ""
        else:
            cur += c
    if cur:
        parts.append(cur)
    return parts


def wordpiece(word: str, vocab: dict[str, int], unk_id: int, prefix: str = "##",
              max_chars: int = MAX_WORD_CHARS) -> list[int]:
    """The WordPiece model on one pre-tokenized word: greedy longest match
    from the left, ``prefix`` on continuations; a word with no full split,
    or longer than ``max_chars`` characters, is ``[unk_id]``."""
    if len(word) > max_chars:
        return [unk_id]
    pieces, start = [], 0
    while start < len(word):
        end = len(word)
        while end > start:
            piece = vocab.get(word[start:end] if start == 0 else prefix + word[start:end])
            if piece is not None:
                break
            end -= 1
        else:
            return [unk_id]
        pieces.append(piece)
        start = end
    return pieces


class WordPieceTokenizer:
    """BERT's tokenizer for a directory with ``vocab.txt``."""

    @staticmethod
    def from_dir(path: str):
        """The ``JsonTokenizer`` that ``BertTokenizerFast`` builds from
        ``vocab.txt`` and, where present, ``tokenizer_config.json``
        (``JsonTokenizer.from_vocab_txt``)."""
        from lotus_tpu_torch.models.tokenizer_json import JsonTokenizer  # that module imports this one

        return JsonTokenizer.from_vocab_txt(path)
