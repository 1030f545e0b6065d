"""Blenderbot-Small's tokenizer: the slow ``BlenderbotSmallTokenizer`` of
``transformers`` (``models/blenderbot_small/tokenization_blenderbot_small.py``),
which ``AutoTokenizer`` builds for the type, since it maps it to no fast
class.  It is not byte-level: ``vocab.json`` and ``merges.txt`` hold
lowercased words and ``@@``-continued pieces.

One text goes through, in order:

1. the added tokens (``__start__``, ``__end__``, ``__unk__``, ``__null__``
   and any others ``tokenizer_config.json`` lists) are split out of it;
2. each run of non-whitespace and the newline after it (``\\S+\\n?``) is
   one word, and each word is cut: a space goes before each of
   ``.,!?()``, spaces around each ``'``, runs of whitespace become one
   space and a newline becomes the token ``__newln__``; each space-separated
   piece is lowercased;
3. a piece of one character is its own token; a longer one is cut into
   characters, the last marked ``</w>``, and merged by ``merges.txt``'s
   ranks, lowest first, until no ranked pair is left; its tokens are the
   pieces joined by ``@@ `` with the final ``</w>`` dropped;
4. a token is the added token of its text, else the vocabulary's id of its
   lowercase, else ``__unk__``'s.

No special tokens are added: a text's ids are its tokens', and a pair's the
two concatenated.  ``merges.txt`` is read as the slow tokenizer reads it:
its first and last lines are skipped (the version header, and the empty
line after the final newline).
"""

from __future__ import annotations

import json
import os
import re

from lotus_tpu_torch.models.tokenizer_json import (
    MEMO_LIMIT, AddedTokens, JsonTokenizer, read_tokenizer_config, special_token,
)

SPECIALS = {"bos_token": "__start__", "eos_token": "__end__", "unk_token": "__unk__", "pad_token": "__null__"}
_WORD = re.compile(r"\S+\n?")
_PUNCT = re.compile("([.,!?()])")
_QUOTE = re.compile("(')")
_SPACES = re.compile(r"\s{2,}")


class BlenderbotSmallTokenizer(JsonTokenizer):
    """The slow tokenizer over ``vocab`` (token -> id) and ``merges`` (pairs
    in rank order), with the special tokens of ``config`` (the parsed
    ``tokenizer_config.json``).  It keeps ``JsonTokenizer``'s interface
    (``encode``, ``pad``, ``__call__``) with its own ``tokenize``, under
    the plain templates (no special tokens)."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, ...]], config: dict | None = None):
        config = config or {}
        names = {k: special_token(config.get(k, v)) for k, v in SPECIALS.items()}
        added = {special_token(t): int(i) for i, t in config.get("added_tokens_decoder", {}).items()}
        flags = {special_token(t): t for t in config.get("added_tokens_decoder", {}).values() if isinstance(t, dict)}
        missing = [t for t in names.values() if t not in added and t not in vocab]
        if missing:
            raise KeyError(f"special tokens {missing} are neither in vocab.json nor added tokens")
        self.added = {**{t: vocab[t] for t in names.values() if t not in added}, **added}
        self.raw_tokens = AddedTokens([{**flags.get(t, {}), "content": t, "id": i} for t, i in self.added.items()])
        self.vocab = {**vocab, **self.added}
        self.ranks = dict(zip(merges, range(len(merges))))
        self.unk_id = self.vocab[names["unk_token"]]
        self.pad_id = self.vocab[names["pad_token"]]
        self.single, self.pair = [("A", 0)], [("A", 0), ("B", 1)]
        self.padding_side = "right"
        self.word_ids = vocab  # vocab.json's own, which tokens are looked up in lowercased
        self._memo: dict[str, list[str]] = {}

    @classmethod
    def from_dir(cls, path: str) -> "BlenderbotSmallTokenizer":
        """``vocab.json``, ``merges.txt`` and, where present,
        ``tokenizer_config.json`` / ``special_tokens_map.json``."""
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            merges = [tuple(line.split()) for line in f.read().split("\n")[1:-1]]
        return cls(vocab, merges, read_tokenizer_config(path))

    def _merge(self, piece: str) -> list[str]:
        """The tokens of one lowercased piece of two or more characters."""
        word = (*piece[:-1], piece[-1] + "</w>")
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            first, second = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if (first, second) not in self.ranks:
                break
            out, i = [], 0
            while i < len(word):
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    out.append(first + second)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
        return "@@ ".join(word)[:-4].split(" ")

    def _pieces(self, word: str) -> list[str]:
        word = _SPACES.sub(" ", _QUOTE.sub(r" \1 ", _PUNCT.sub(r" \1", word)))
        word = word.replace("\n", " __newln__")
        out = []
        for piece in word.split(" "):
            if not piece:
                continue
            piece = piece.lower()
            if len(piece) == 1:
                out.append(piece)
                continue
            got = self._memo.get(piece)
            if got is None:
                if len(self._memo) >= MEMO_LIMIT:
                    self._memo.clear()
                got = self._memo[piece] = self._merge(piece)
            out += got
        return out

    def _id(self, token: str) -> int:
        got = self.added.get(token)
        return got if got is not None else self.word_ids.get(token.lower(), self.unk_id)

    def tokenize(self, text: str) -> list[int]:
        """The ids of ``text``."""
        ids: list[int] = []
        for (piece, _), tok in self.raw_tokens.split((text, True)):
            if tok is not None:
                ids.append(tok)
                continue
            for word in _WORD.findall(piece):
                ids += [self._id(t) for t in self._pieces(word)]
        return ids
