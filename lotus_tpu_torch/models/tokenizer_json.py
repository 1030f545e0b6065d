"""A tokenizer read from ``tokenizer.json``, the format of the ``tokenizers``
library that ``transformers``' fast tokenizers save, with the same ids and
no ``tokenizers``, ``sentencepiece`` or ``regex`` package.

One text goes through, in order:

1. the added tokens: those with ``normalized: false`` are split out of the
   raw text, leftmost-longest, with ``lstrip`` / ``rstrip`` taking the
   whitespace beside them and ``single_word`` refusing a match inside a
   word; the other pieces are normalized, and then the ``normalized: true``
   tokens are split out of them;
2. the normalizer: ``Sequence``, ``BertNormalizer``, ``NFC`` / ``NFD`` /
   ``NFKC`` / ``NFKD``, ``Lowercase``, ``Strip``, ``StripAccents``,
   ``Replace`` (a string or a ``Regex``) and ``Precompiled``
   (``charsmap.py``);
3. the pre-tokenizer: ``Sequence``, ``BertPreTokenizer``, ``ByteLevel``
   (``bpe.py``), ``Metaspace`` (``prepend_scheme`` ``always`` / ``first`` /
   ``never``, or the older ``add_prefix_space``) and ``WhitespaceSplit``;
4. the model, on each word, memoised: ``WordPiece`` (``wordpiece.py``'s),
   ``BPE`` (``bpe.py``) or ``Unigram`` (``unigram.py``);
5. the post-processor: ``BertProcessing``, ``RobertaProcessing``,
   ``TemplateProcessing`` or ``ByteLevel`` (which adds nothing), after
   truncation, which counts the special tokens it adds (``longest_first``
   for a pair).

Any other component raises ``NotImplementedError`` naming it.  What
``transformers`` changes at load time from ``tokenizer_config.json`` is
applied too: ``do_lower_case``, ``strip_accents`` and
``tokenize_chinese_chars`` on a ``BertNormalizer``, ``add_prefix_space`` on
a ``ByteLevel`` pre-tokenizer.  Padding uses the tokenizer's own
``pad_token`` (1 for RoBERTa and XLM-R).  A directory without
``tokenizer.json`` gives the tokenizer that ``transformers`` converts its
vocabulary files into: ``from_vocab_txt`` (BERT's WordPiece) and
``from_vocab_merges`` (RoBERTa's byte-level BPE).  Encodings are int64
numpy arrays.

A directory whose tokenizer ``AutoTokenizer`` would build as
``RoFormerTokenizer`` (named by ``tokenizer_config.json`` or ``config.json``,
or a ``roformer`` model without a tokenizer class) is refused with
``NotImplementedError``: ``RoFormerTokenizerFast`` cuts words with jieba
(a custom ``JiebaPreTokenizer`` over ``rjieba``) that ``tokenizer.json``
does not record (``save_pretrained`` writes a ``BertPreTokenizer`` in its
place), so reading the file would tokenize differently without an error.
"""

from __future__ import annotations

import base64
import json
import os
import re
import unicodedata
from functools import partial, reduce
from typing import Callable, Iterator, Sequence

import numpy as np

from lotus_tpu_torch.models.bpe import BPE, WHITE_SPACE, byte_level_words, read_merges
from lotus_tpu_torch.models.charsmap import Charsmap
from lotus_tpu_torch.models.unigram import Unigram
from lotus_tpu_torch.models.wordpiece import bert_normalize, lowercase, split_punctuation, wordpiece

MEMO_LIMIT = 1 << 20  # words memoised before the memo starts over
# Pre-tokenizers that cut only inside whitespace-separated chunks, each as
# its cut of one chunk: a chunk's ids are memoised whole.
CHUNK_LOCAL: dict[str, Callable[[str], list[str]]] = {"BertPreTokenizer": split_punctuation,
                                                      "WhitespaceSplit": lambda chunk: [chunk]}
_NOT_WS = re.compile(f"[^{WHITE_SPACE}]+")
_WS_CHARS = re.sub(f"[^{WHITE_SPACE}]", "", "".join(map(chr, range(0x3001))))  # Unicode's White_Space
_WORD_CHAR = re.compile(r"\w")

Piece = tuple[str, bool]  # (text, whether it starts where the original text starts)


# ---- normalizers -------------------------------------------------------------

def _replace(spec: dict) -> Callable[[str], str]:
    pattern, content = spec["pattern"], spec["content"]
    if "String" in pattern:
        return lambda text: text.replace(pattern["String"], content)
    regex = re.compile(pattern["Regex"])
    return lambda text: regex.sub(lambda _: content, text)


def _strip(spec: dict) -> Callable[[str], str]:
    left, right = spec.get("strip_left", True), spec.get("strip_right", True)

    def strip(text: str) -> str:
        text = text.lstrip(_WS_CHARS) if left else text
        return text.rstrip(_WS_CHARS) if right else text

    return strip


def _strip_accents(text: str) -> str:
    return "".join(c for c in text if not unicodedata.category(c).startswith("M"))


def normalizer(spec: dict | None) -> Callable[[str], str] | None:
    """The normalizer ``spec`` describes, as a function of the text."""
    if spec is None:
        return None
    kind = spec["type"]
    if kind == "Sequence":
        parts = [normalizer(s) for s in spec["normalizers"]]
        return lambda text: reduce(lambda t, f: f(t), parts, text)
    if kind == "BertNormalizer":
        lower, strip = spec.get("lowercase", True), spec.get("strip_accents")
        return partial(bert_normalize, clean_text=spec.get("clean_text", True),
                       handle_chinese_chars=spec.get("handle_chinese_chars", True),
                       strip_accents=lower if strip is None else strip, lowercase_text=lower)
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return partial(unicodedata.normalize, kind)
    if kind == "Lowercase":
        return lowercase
    if kind == "Strip":
        return _strip(spec)
    if kind == "StripAccents":
        return _strip_accents
    if kind == "Replace":
        return _replace(spec)
    if kind == "Precompiled":
        return Charsmap(base64.b64decode(spec["precompiled_charsmap"])).normalize
    raise NotImplementedError(f"normalizer {kind!r}: the port reads Sequence, BertNormalizer, NFC, NFD, NFKC, "
                              f"NFKD, Lowercase, Strip, StripAccents, Replace and Precompiled")


# ---- pre-tokenizers ----------------------------------------------------------

def _chunks(text: str) -> list[str]:
    """The whitespace-separated chunks of ``text`` (Unicode's White_Space;
    ``str.split`` also cuts at U+001C-U+001F, and is much the faster)."""
    if "\x1c" in text or "\x1d" in text or "\x1e" in text or "\x1f" in text:
        return _NOT_WS.findall(text)
    return text.split()


def _split_runs(piece: Piece, pattern: re.Pattern) -> list[Piece]:
    text, at_start = piece
    return [(m.group(), at_start and m.start() == 0) for m in pattern.finditer(text)]


def _bert_words(piece: Piece) -> list[Piece]:
    out = []
    for word, at_start in _split_runs(piece, _NOT_WS):
        out += [(part, at_start and k == 0) for k, part in enumerate(split_punctuation(word))]
    return out


def _byte_level(spec: dict) -> Callable[[Piece], list[Piece]]:
    prefix = spec.get("add_prefix_space", False)
    use_regex = spec.get("use_regex", True)

    def split(piece: Piece) -> list[Piece]:
        words = byte_level_words(piece[0], prefix, use_regex)
        return [(w, piece[1] and k == 0) for k, w in enumerate(words)]

    return split


def _metaspace(spec: dict) -> Callable[[Piece], list[Piece]]:
    mark = spec.get("replacement", "▁")
    scheme = spec.get("prepend_scheme", "always" if spec.get("add_prefix_space", True) else "never")
    if scheme not in ("always", "first", "never"):
        raise NotImplementedError(f"Metaspace prepend_scheme {scheme!r}")
    split_words = spec.get("split", True)
    pattern = re.compile(f"[^{re.escape(mark)}]+|{re.escape(mark)}[^{re.escape(mark)}]*")

    def split(piece: Piece) -> list[Piece]:
        text, at_start = piece
        text = text.replace(" ", mark)
        if (scheme == "always" or (scheme == "first" and at_start)) and not text.startswith(mark):
            text = mark + text
        if not split_words:
            return [(text, at_start)]
        return [(w, at_start and k == 0) for k, w in enumerate(pattern.findall(text))]

    return split


def pre_tokenizer(spec: dict | None) -> Callable[[Piece], list[Piece]]:
    """The pre-tokenizer ``spec`` describes, as a function from one piece
    of normalized text to its words."""
    if spec is None:
        return lambda piece: [piece]
    kind = spec["type"]
    if kind == "Sequence":
        parts = [pre_tokenizer(s) for s in spec["pretokenizers"]]
        return lambda piece: reduce(lambda ws, f: [w for p in ws for w in f(p)], parts, [piece])
    if kind == "BertPreTokenizer":
        return _bert_words
    if kind == "WhitespaceSplit":
        return partial(_split_runs, pattern=_NOT_WS)
    if kind == "ByteLevel":
        return _byte_level(spec)
    if kind == "Metaspace":
        return _metaspace(spec)
    raise NotImplementedError(f"pre-tokenizer {kind!r}: the port reads Sequence, BertPreTokenizer, ByteLevel, "
                              f"Metaspace and WhitespaceSplit")


# ---- models ------------------------------------------------------------------

def model(spec: dict) -> tuple[Callable[[str], list[int]], dict[str, int]]:
    """The model ``spec`` describes, as a function from one word to its
    ids, and its vocabulary (token -> id)."""
    kind = spec["type"]
    if kind == "WordPiece":
        vocab = spec["vocab"]
        return partial(wordpiece, vocab=vocab, unk_id=vocab[spec["unk_token"]],
                       prefix=spec.get("continuing_subword_prefix", "##"),
                       max_chars=spec.get("max_input_chars_per_word", 100)), vocab
    if kind == "BPE":
        merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m) for m in spec["merges"]]
        bpe = BPE(spec["vocab"], merges, unk_token=spec.get("unk_token"),
                  continuing_subword_prefix=spec.get("continuing_subword_prefix"),
                  end_of_word_suffix=spec.get("end_of_word_suffix"), fuse_unk=spec.get("fuse_unk", False),
                  byte_fallback=spec.get("byte_fallback", False), ignore_merges=spec.get("ignore_merges", False),
                  dropout=spec.get("dropout"))
        return bpe, spec["vocab"]
    if kind == "Unigram":
        uni = Unigram([(p, s) for p, s in spec["vocab"]], spec.get("unk_id"),
                      byte_fallback=spec.get("byte_fallback", False), fuse_unk=spec.get("fuse_unk", True))
        return uni, uni.ids
    raise NotImplementedError(f"model {kind!r}: the port reads WordPiece, BPE and Unigram")


# ---- post-processors ---------------------------------------------------------

# A template: a list of ("A" or "B", type id) for a sequence, or (ids, type id)
# for special tokens.
Template = list[tuple[str | list[int], int]]


def _template(items: list[dict], specials: dict) -> Template:
    out: Template = []
    for item in items:
        if "Sequence" in item:
            out.append((item["Sequence"]["id"], item["Sequence"]["type_id"]))
        else:
            tok = item["SpecialToken"]
            out.append((list(specials[tok["id"]]["ids"]), tok["type_id"]))
    return out


def post_processor(spec: dict | None) -> tuple[Template, Template]:
    """The (single, pair) templates of the post-processor ``spec``."""
    plain: tuple[Template, Template] = ([("A", 0)], [("A", 0), ("B", 1)])
    if spec is None:
        return plain
    kind = spec["type"]
    if kind == "BertProcessing":
        cls, sep = [spec["cls"][1]], [spec["sep"][1]]
        return [(cls, 0), ("A", 0), (sep, 0)], [(cls, 0), ("A", 0), (sep, 0), ("B", 1), (sep, 1)]
    if kind == "RobertaProcessing":
        cls, sep = [spec["cls"][1]], [spec["sep"][1]]
        return [(cls, 0), ("A", 0), (sep, 0)], [(cls, 0), ("A", 0), (sep, 0), (sep, 0), ("B", 0), (sep, 0)]
    if kind == "TemplateProcessing":
        return _template(spec["single"], spec["special_tokens"]), _template(spec["pair"], spec["special_tokens"])
    if kind == "ByteLevel":
        return plain
    raise NotImplementedError(f"post-processor {kind!r}: the port reads BertProcessing, RobertaProcessing, "
                              f"TemplateProcessing and ByteLevel")


def _added(template: Template) -> int:
    return sum(len(part) for part, _ in template if not isinstance(part, str))


# ---- truncation ----------------------------------------------------------------

def room(max_length: int, added: int) -> int:
    """The tokens left for the text(s) once ``added`` special tokens are in."""
    if max_length < added:
        raise ValueError(f"max_length {max_length} leaves no room beside {added} special tokens")
    return max_length - added


def longest_first(a: list[int], b: list[int], budget: int) -> tuple[list[int], list[int]]:
    """The ``tokenizers`` library's ``longest_first``: the shorter sequence
    keeps its length where the longer can take the rest, else each keeps
    half (the longer one the odd token)."""
    if len(a) + len(b) <= budget:
        return a, b
    n1, n2 = sorted((len(a), len(b)))
    n2 = n1 if n1 > budget else max(n1, budget - n1)
    if n1 + n2 > budget:
        n1, n2 = budget // 2, budget // 2 + budget % 2
    if len(a) > len(b):
        n1, n2 = n2, n1
    return a[:n1], b[:n2]


# ---- the tokenizer -----------------------------------------------------------

def special_token(value) -> str:
    """A special token as ``tokenizer_config.json`` writes it: a string or an
    added-token dict."""
    return value["content"] if isinstance(value, dict) else str(value)


class AddedTokens:
    """The added tokens matched in one stage (raw or normalized text)."""

    def __init__(self, tokens: list[dict]):
        self.tokens = {t["content"]: t for t in tokens}
        alternatives = sorted(self.tokens, key=len, reverse=True)  # leftmost-longest
        self.pattern = re.compile("|".join(map(re.escape, alternatives))) if alternatives else None

    def split(self, piece: Piece) -> Iterator[tuple[Piece, int | None]]:
        """(piece, None) for text between tokens, ((content, False), id)
        for each token; empty pieces are dropped."""
        text, at_start = piece
        if self.pattern is None:
            if text:
                yield piece, None
            return
        done = 0
        for m in self.pattern.finditer(text):
            start, stop = m.span()
            tok = self.tokens[m.group()]
            if tok.get("single_word") and ((start > 0 and _WORD_CHAR.match(text[start - 1]))
                                           or (stop < len(text) and _WORD_CHAR.match(text[stop]))):
                continue
            if tok.get("lstrip"):
                start = max(len(text[:start].rstrip(_WS_CHARS)), done)
            if tok.get("rstrip"):
                stop = len(text) - len(text[stop:].lstrip(_WS_CHARS))
            if done < start:
                yield (text[done:start], at_start and done == 0), None
            yield (m.group(), False), tok["id"]
            done = stop
        if done < len(text):
            yield (text[done:], at_start and done == 0), None


class JsonTokenizer:
    """A tokenizer from the parsed ``tokenizer.json`` ``spec``, with
    ``config`` the ``tokenizer_config.json`` beside it: what the RM and the
    reranker call (``encode``, ``pad``, ``__call__``)."""

    def __init__(self, spec: dict, config: dict | None = None):
        config = config or {}
        added = spec.get("added_tokens", [])
        self.raw_tokens = AddedTokens([t for t in added if not t.get("normalized", False)])
        self.norm_tokens = AddedTokens([t for t in added if t.get("normalized", False)])
        norm, pre = spec.get("normalizer"), spec.get("pre_tokenizer")
        if norm is not None and norm["type"] == "BertNormalizer":  # as BertTokenizerFast.__init__ does
            keys = {"do_lower_case": "lowercase", "strip_accents": "strip_accents",
                    "tokenize_chinese_chars": "handle_chinese_chars"}
            norm = {**norm, **{v: config[k] for k, v in keys.items() if k in config}}
        if pre is not None and pre["type"] == "ByteLevel" and "add_prefix_space" in config:  # RobertaTokenizerFast
            pre = {**pre, "add_prefix_space": config["add_prefix_space"]}
        self._normalize = normalizer(norm) or (lambda text: text)
        self.pre_tokenize = pre_tokenizer(pre)
        self.model, vocab = model(spec["model"])
        self._cut = None if pre is None else CHUNK_LOCAL.get(pre["type"])
        self.single, self.pair = post_processor(spec.get("post_processor"))
        self.vocab = {**vocab, **{t["content"]: t["id"] for t in added}}
        pad = config.get("pad_token")
        if pad is None and spec.get("padding"):
            pad = spec["padding"].get("pad_token")
        self.pad_id = None if pad is None else self.vocab.get(special_token(pad))
        self._memo: dict[str, list[int]] = {}

    @classmethod
    def from_dir(cls, path: str) -> "JsonTokenizer":
        """``tokenizer.json`` and, where present, ``tokenizer_config.json``
        (whose special tokens ``special_tokens_map.json`` completes)."""
        with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
            spec = json.load(f)
        return cls(spec, _read_config(path))

    @classmethod
    def from_vocab_txt(cls, path: str) -> "JsonTokenizer":
        """A directory with ``vocab.txt`` (one token a line, its line number
        its id): the WordPiece tokenizer ``BertTokenizerFast`` builds from it
        (``BertConverter``: the special tokens split out of the raw text,
        ``BertNormalizer``, ``BertPreTokenizer``, ``WordPiece``,
        ``[CLS] A [SEP] B [SEP]``), with BERT's special tokens unless
        ``tokenizer_config.json`` names others; ``do_lower_case``,
        ``strip_accents`` and ``tokenize_chinese_chars`` come from it too."""
        config = _read_config(path)
        vocab: dict[str, int] = {}
        with open(os.path.join(path, "vocab.txt"), encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        names = {"unk_token": "[UNK]", "sep_token": "[SEP]", "pad_token": "[PAD]", "cls_token": "[CLS]",
                 "mask_token": "[MASK]"}
        names.update({k: special_token(config[k]) for k in names if config.get(k) is not None})
        missing = [tok for tok in names.values() if tok not in vocab]
        if missing:
            raise KeyError(f"special tokens {missing} are not in the vocabulary")
        spec = {
            "added_tokens": [{"content": tok, "id": vocab[tok], "normalized": False} for tok in dict.fromkeys(names.values())],
            "normalizer": {"type": "BertNormalizer"},
            "pre_tokenizer": {"type": "BertPreTokenizer"},
            "post_processor": {"type": "BertProcessing", "sep": [names["sep_token"], vocab[names["sep_token"]]],
                               "cls": [names["cls_token"], vocab[names["cls_token"]]]},
            "model": {"type": "WordPiece", "vocab": vocab, "unk_token": names["unk_token"]},
        }
        return cls(spec, {"pad_token": names["pad_token"], **config})

    @classmethod
    def from_vocab_merges(cls, path: str) -> "JsonTokenizer":
        """A directory with only ``vocab.json`` and ``merges.txt``: the
        byte-level BPE tokenizer ``RobertaTokenizerFast`` builds from them
        (``RobertaConverter``: no normalizer, ``ByteLevel`` pre-tokenizer,
        ``RobertaProcessing``), with RoBERTa's special tokens unless
        ``tokenizer_config.json`` names others."""
        config = _read_config(path)
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        names = {"bos_token": "<s>", "eos_token": "</s>", "sep_token": "</s>", "cls_token": "<s>",
                 "unk_token": "<unk>", "pad_token": "<pad>", "mask_token": "<mask>"}
        names.update({k: special_token(config[k]) for k in names if config.get(k) is not None})
        added = [{"content": tok, "id": vocab[tok], "lstrip": key == "mask_token", "normalized": False}
                 for key, tok in names.items() if tok in vocab]
        spec = {
            "added_tokens": list({t["content"]: t for t in added}.values()),
            "normalizer": None,
            "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False, "use_regex": True},
            "post_processor": {"type": "RobertaProcessing", "sep": [names["sep_token"], vocab[names["sep_token"]]],
                               "cls": [names["cls_token"], vocab[names["cls_token"]]]},
            "model": {"type": "BPE", "vocab": vocab, "merges": read_merges(os.path.join(path, "merges.txt")),
                      "unk_token": None},
        }
        return cls(spec, {"pad_token": names["pad_token"], **config})

    def _word_ids(self, word: str) -> list[int]:
        """The ids of a memo key: a pre-tokenized word, or a whitespace-
        separated chunk under a ``CHUNK_LOCAL`` pre-tokenizer."""
        if self._cut is not None:
            return [i for w in self._cut(word) for i in self.model(w)]
        return self.model(word)

    def _words(self, piece: Piece) -> list[int]:
        ids: list[int] = []
        memo = self._memo
        words = _chunks(piece[0]) if self._cut is not None else [w for w, _ in self.pre_tokenize(piece)]
        for word in words:
            got = memo.get(word)
            if got is None:
                if len(memo) >= MEMO_LIMIT:
                    memo.clear()
                got = memo[word] = self._word_ids(word)
            ids += got
        return ids

    def tokenize(self, text: str) -> list[int]:
        """The ids of ``text``, without the post-processor's special tokens."""
        ids: list[int] = []
        for piece, tok in self.raw_tokens.split((text, True)):
            if tok is not None:
                ids.append(tok)
                continue
            for sub, tok2 in self.norm_tokens.split((self._normalize(piece[0]), piece[1])):
                if tok2 is not None:
                    ids.append(tok2)
                else:
                    ids += self._words(sub)
        return ids

    def _encode(self, texts: Sequence[str], text_pair: Sequence[str] | None,
                max_length: int | None) -> Iterator[tuple[list[int], list[int]]]:
        for j, text in enumerate(texts):
            seqs = {"A": self.tokenize(text)}
            template = self.single
            if text_pair is not None:
                seqs["B"] = self.tokenize(text_pair[j])
                template = self.pair
            if max_length is not None:
                budget = room(max_length, _added(template))
                if text_pair is None:
                    seqs["A"] = seqs["A"][:budget]
                else:
                    seqs["A"], seqs["B"] = longest_first(seqs["A"], seqs["B"], budget)
            ids: list[int] = []
            types: list[int] = []
            for part, type_id in template:
                got = seqs[part] if isinstance(part, str) else part
                ids += got
                types += [type_id] * len(got)
            yield ids, types

    def encode(self, texts: Sequence[str], text_pair: Sequence[str] | None = None,
               max_length: int | None = None) -> list[list[int]]:
        """The ids of each text (or pair), with the special tokens; a pair
        is cut ``longest_first`` to ``max_length``."""
        return [ids for ids, _ in self._encode(texts, text_pair, max_length)]

    def pad(self, encoded: list[list[int]], length: int) -> tuple[np.ndarray, np.ndarray]:
        """``(input_ids, attention_mask)``, each (len(encoded), length)
        int64, padded on the right with ``pad_id``."""
        if self.pad_id is None:
            raise ValueError("the tokenizer has no padding token")
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
        longest, ``"max_length"`` to ``max_length``; with the token types
        the post-processor gives (1 on a BERT pair's second segment)."""
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
        for r, (_, t) in enumerate(rows):
            types[r, : len(t)] = t
        return {"input_ids": ids, "token_type_ids": types, "attention_mask": mask}


JIEBA_TOKENIZERS = ("RoFormerTokenizer", "RoFormerTokenizerFast")


def _read_json(path: str, name: str) -> dict:
    p = os.path.join(path, name)
    if not os.path.exists(p):
        return {}
    with open(p, encoding="utf-8") as f:
        return {k: v for k, v in json.load(f).items() if v is not None}


def _read_config(path: str) -> dict:
    """``tokenizer_config.json``, its special tokens completed from
    ``special_tokens_map.json``; empty where neither is there.  Refuses a
    directory whose tokenizer is RoFormer's (jieba)."""
    config = {**_read_json(path, "special_tokens_map.json"), **_read_json(path, "tokenizer_config.json")}
    model = _read_json(path, "config.json")
    # AutoTokenizer's order: tokenizer_config's class, config.json's, the model type's.
    cls = config.get("tokenizer_class") or model.get("tokenizer_class")
    if cls in JIEBA_TOKENIZERS or (cls is None and model.get("model_type") == "roformer"):
        raise NotImplementedError(
            f"{path}: the tokenizer is {cls or 'RoFormerTokenizer'}, which cuts Chinese words with jieba (rjieba) "
            f"before WordPiece; tokenizer.json does not record that cut, and the port has no jieba dictionary yet, "
            f"so the cut waits until one is in the repository (name a WordPiece tokenizer_class such as "
            f"BertTokenizer to read this directory without jieba)")
    return config
