"""Marian's tokenizer, the source side of ``transformers``' slow
``MarianTokenizer`` (``models/marian/tokenization_marian.py``), which
``AutoTokenizer`` builds for the type (it has no fast class): ``source.spm``
read by the port (``sentencepiece.py``), ids from ``vocab.json``.

One text goes through what the slow base class does
(``sentencepiece.SlowTokenizer``: the special tokens split off, each piece
between them alone), then, on each piece:

1. a leading ``>>xx<<`` language code is split off as one token
   (``remove_language_code``);
2. ``source.spm`` encodes the rest (``encode(text, out_type=str)``);
3. each token's id is its ``vocab.json`` entry, else ``<unk>``'s (a
   ``vocab.json`` without the unknown token raises ``KeyError``, as
   ``__init__`` does, and so does one without the pad token);
4. ``</s>`` is appended (``build_inputs_with_special_tokens``: ``A </s>``,
   ``A B </s>``).

No punctuation normalization is applied: ``__init__`` builds a
``MosesPunctNormalizer`` (``_setup_normalizer``), but nothing on
``__call__``'s path calls ``normalize``.  Only the source side is read:
``target.spm`` and ``target_vocab.json`` serve ``text_target``, which the
RM never passes.
"""

from __future__ import annotations

import json
import os

from lotus_tpu_torch.models.sentencepiece import SentencePieceEncoder, SlowTokenizer
from lotus_tpu_torch.models.tokenizer_json import read_tokenizer_config, special_token


def remove_language_code(text: str) -> tuple[list[str], str]:
    """A leading ``>>xx<<`` split off the text."""
    end = text.find("<<")
    if text.startswith(">>") and end != -1:
        return [text[: end + 2]], text[end + 2 :]
    return [], text


class MarianTokenizer(SlowTokenizer):
    """The slow tokenizer's source side over ``encoder`` (``source.spm``)
    and ``vocab`` (``vocab.json``), with ``config`` the parsed
    ``tokenizer_config.json``."""

    def __init__(self, encoder: SentencePieceEncoder, vocab: dict[str, int], config: dict | None = None):
        config = config or {}
        if (config.get("sp_model_kwargs") or {}).get("enable_sampling"):
            raise NotImplementedError("sp_model_kwargs enable_sampling: the port encodes deterministically")
        specials = {k: special_token(config.get(k, v)) for k, v in
                    (("unk_token", "<unk>"), ("eos_token", "</s>"), ("pad_token", "<pad>"))}
        for key in ("unk_token", "pad_token"):
            if specials[key] not in vocab:
                raise KeyError(f"{specials[key]} token must be in the vocab (vocab.json)")
        super().__init__(vocab, specials, config, [], [])
        eos = self.vocab[specials["eos_token"]]
        self.single, self.pair = [("A", 0), ([eos], 0)], [("A", 0), ("B", 0), ([eos], 0)]
        self.sp = encoder
        self.encoder = vocab
        self.unk_id = vocab[specials["unk_token"]]

    @classmethod
    def from_dir(cls, path: str) -> "MarianTokenizer":
        """``source.spm``, ``vocab.json`` and, where present,
        ``tokenizer_config.json`` / ``special_tokens_map.json``."""
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        return cls(SentencePieceEncoder.from_file(os.path.join(path, "source.spm")), vocab,
                   read_tokenizer_config(path))

    def _tokenize(self, text: str) -> list[str]:
        code, text = remove_language_code(text)
        return code + self.sp.encode(text)

    def _convert(self, token: str) -> int:
        return self.encoder.get(token, self.unk_id)
