"""GPT-SW3's tokenizer: the slow ``GPTSw3Tokenizer`` of ``transformers``
(``models/gpt_sw3/tokenization_gpt_sw3.py``), which ``AutoTokenizer``
builds for the type (it has no fast class), over ``spiece.model`` read by
the port (``sentencepiece.py``).

One text goes through what the slow base class does
(``sentencepiece.SlowTokenizer``: ``do_lower_case``, the special tokens
split off, each piece between them alone), then, on each piece,
``preprocess_text`` and the sentencepiece model:

1. the non-printing characters 0-8, 11-31, 127-159, 160, 173 and 8203 are
   removed;
2. the class's ``whitespaces`` (U+2002, U+2003, U+2005, U+2008, U+2009,
   U+200A, U+202F, U+3000, U+FFFC and U+0084) become a space;
3. NFC;
4. ``sp_model.encode(text, out_type=str)``, each piece's id its
   ``PieceToId`` (the unknown id for an unknown piece).

No special token is added (the base ``build_inputs_with_special_tokens``).
The special tokens default as ``__init__`` sets them: ``<unk>``,
``<|endoftext|>``, ``<pad>`` and ``<s>``, but where the directory's name
holds ``gpt-sw3-7b`` the pad token is the unknown token and bos the eos
token.  ``do_lower_case``, ``remove_space`` and ``keep_accents`` are stored
by the class and only the first is read (by the base class); a
``sp_model_kwargs`` that samples is refused.
"""

from __future__ import annotations

import os
import unicodedata

from lotus_tpu_torch.models.sentencepiece import SentencePieceEncoder, SlowTokenizer
from lotus_tpu_torch.models.tokenizer_json import read_tokenizer_config, special_token

NON_PRINTING = [*range(0, 9), *range(11, 32), *range(127, 160), 160, 173, 8203]
WHITESPACES = "\u2002\u2003\u2005\u2008\u2009\u200a\u202f\u3000\ufffc\x84"  # the class's, but the space
PREPROCESS = {**{c: " " for c in map(ord, WHITESPACES)}, **dict.fromkeys(NON_PRINTING)}


def preprocess_text(text: str) -> str:
    """``GPTSw3Tokenizer.preprocess_text``: the non-printing characters
    removed, the whitespaces made spaces, NFC."""
    return unicodedata.normalize("NFC", text.translate(PREPROCESS))


class GPTSw3Tokenizer(SlowTokenizer):
    """The slow tokenizer over ``encoder`` (``spiece.model``), with
    ``config`` the parsed ``tokenizer_config.json`` and ``name_or_path`` the
    directory ``from_pretrained`` was given."""

    def __init__(self, encoder: SentencePieceEncoder, config: dict | None = None, name_or_path: str = ""):
        config = config or {}
        if (config.get("sp_model_kwargs") or {}).get("enable_sampling"):
            raise NotImplementedError("sp_model_kwargs enable_sampling: the port encodes deterministically")
        names = {k: special_token(config[k]) for k in ("bos_token", "eos_token", "unk_token", "pad_token")
                 if config.get(k) is not None}
        eos = names.get("eos_token", "<|endoftext|>")
        unk = names.get("unk_token", "<unk>")
        seven_b = "gpt-sw3-7b" in name_or_path
        specials = {"bos_token": names.get("bos_token", eos if seven_b else "<s>"), "eos_token": eos,
                    "unk_token": unk, "pad_token": names.get("pad_token", unk if seven_b else "<pad>")}
        vocab = {p.piece: i for i, p in enumerate(encoder.proto.pieces)}  # get_vocab: IdToPiece of each id
        super().__init__(vocab, specials, config, [("A", 0)], [("A", 0), ("B", 1)])
        self.sp = encoder

    @classmethod
    def from_dir(cls, path: str) -> "GPTSw3Tokenizer":
        """``spiece.model`` and, where present, ``tokenizer_config.json`` /
        ``special_tokens_map.json``; ``path`` is the name the defaults
        read."""
        return cls(SentencePieceEncoder.from_file(os.path.join(path, "spiece.model")), read_tokenizer_config(path),
                   name_or_path=path)

    def _tokenize(self, text: str) -> list[str]:
        return self.sp.encode(preprocess_text(text))

    def _convert(self, token: str) -> int:
        return self.sp.piece_to_id(token)
