"""sentencepiece ``.model`` files without ``sentencepiece`` or ``protobuf``:
a reader of the ``ModelProto`` wire format (``read_model``) and an encoder
(``SentencePieceEncoder``) that turns text into pieces as
``SentencePieceProcessor.encode(text, out_type=str)`` does.  GPT-SW3's
``spiece.model`` and Marian's ``source.spm`` are such files
(``gpt_sw3_tokenizer.py``, ``marian_tokenizer.py``).

**The reader.**  A message is a run of fields, each a varint key (field
number << 3 | wire type) and a value: a varint (0), 8 bytes (1), a varint
length and that many bytes (2), or 4 bytes (5); groups (3 ... 4) and every
field the port does not read are skipped by wire type.  The fields read, by
number, with proto2's declared defaults for an absent field (not zero),
from ``sentencepiece_model.proto`` as ``transformers/utils/
sentencepiece_model_pb2.py``'s descriptor declares them:

- ``ModelProto``: ``pieces`` 1 (repeated), ``trainer_spec`` 2,
  ``normalizer_spec`` 3;
- ``SentencePiece``: ``piece`` 1, ``score`` 2 (a fixed32 float), ``type`` 3
  (NORMAL 1 by default; UNKNOWN 2, CONTROL 3, USER_DEFINED 4, UNUSED 5,
  BYTE 6);
- ``TrainerSpec``: ``model_type`` 3 (UNIGRAM 1 by default; BPE 2, WORD 3,
  CHAR 4), ``split_by_whitespace`` 22 (true), ``treat_whitespace_as_suffix``
  24 (false), ``split_digits`` 25 (false), ``byte_fallback`` 35 (false),
  ``unk_id`` 40 (0), ``bos_id`` 41 (1), ``eos_id`` 42 (2), ``pad_id`` 43
  (-1), ``unk_piece`` 45 (``<unk>``);
- ``NormalizerSpec``: ``name`` 1, ``precompiled_charsmap`` 2,
  ``add_dummy_prefix`` 3, ``remove_extra_whitespaces`` 4 and
  ``escape_whitespaces`` 5 (each true by default).

As protobuf parses them, an int32 is the low 32 bits of its varint (so -1
is ten bytes), an enum value outside the enum leaves the field as it was,
a field whose wire type is not its own is skipped, a scalar given twice
keeps the last value and a message given twice is merged.

**The encoder** follows sentencepiece's C++ (``normalizer.cc``,
``unigram_model.cc``, ``bpe_model.cc``, ``sentencepiece_processor.cc``):

1. normalize: at each position a user-defined piece (the longest) is kept
   as it is, else the longest key of ``precompiled_charsmap`` is replaced
   (``charsmap.Charsmap.longest``), else the character is kept; under
   ``remove_extra_whitespaces`` the leading and trailing spaces go and a
   space after a space is dropped; spaces become ``▁`` under
   ``escape_whitespaces``; ``add_dummy_prefix`` puts one ``▁`` in front of
   a non-empty text (behind it under ``treat_whitespace_as_suffix``);
2. the model, on the normalized text: ``unigram.py``'s Viterbi over the
   NORMAL and USER_DEFINED pieces (a USER_DEFINED one scores its UTF-8
   length times the largest NORMAL score, at least ``FLT_MIN``, less 0.1;
   a character no piece starts with is unknown at the smallest NORMAL
   score less 10; unknown characters are not fused there), or a BPE that
   starts from the characters (a user-defined piece one frozen symbol) and
   merges the adjacent pair whose joined piece scores highest, the leftmost
   of equals, until no pair joins into a piece, then splits each UNUSED
   piece back into the pair that made it.  CONTROL and BYTE pieces are never produced from text;
3. each unknown piece becomes the ``<0xNN>`` pieces of its UTF-8 bytes
   under ``byte_fallback``; without it, a run of unknown pieces becomes one
   piece, the normalized text it covers (whose id is the unknown id).

Where no piece holds ``▁`` after another character (before, under
``treat_whitespace_as_suffix``), as in every model trained with
``split_by_whitespace``, no piece crosses a word's start, so the model runs
word by word (each word memoised) with the same result; otherwise on the
whole text.  One difference is left: sentencepiece sums a path's scores in
float32 over the whole text, the port in float64 over each word, so two
paths whose scores tie within float32 rounding may resolve differently.

Where the ``tokenizers`` conversion of such a model (``SpmConverter``)
differs, this follows sentencepiece: a trailing ``▁`` of the text is
dropped, ``remove_extra_whitespaces`` and ``add_dummy_prefix`` are read,
a user-defined piece inside a word keeps the word's other characters
without a ``▁`` of their own, a ``<0xNN>`` or CONTROL piece is never read
from text, and unknown characters become bytes under ``byte_fallback``
(``tests/test_torch_sentencepiece.py`` names each case).

``SlowTokenizer`` is what ``transformers``' slow ``PreTrainedTokenizer``
does around such a model, for GPT-SW3's and Marian's tokenizers.
"""

from __future__ import annotations

import re
import struct
from dataclasses import dataclass, replace
from heapq import heappop, heappush
from typing import Iterator

from lotus_tpu_torch.models.charsmap import Charsmap
from lotus_tpu_torch.models.tokenizer_json import AddedTokens, JsonTokenizer, Template, special_token
from lotus_tpu_torch.models.unigram import Unigram

NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
PIECE_TYPES = {1: "NORMAL", 2: "UNKNOWN", 3: "CONTROL", 4: "USER_DEFINED", 5: "UNUSED", 6: "BYTE"}
UNIGRAM, BPE = 1, 2
MODEL_TYPES = {1: "UNIGRAM", 2: "BPE", 3: "WORD", 4: "CHAR"}
VARINT, FIXED64, LENGTH, START_GROUP, END_GROUP, FIXED32 = 0, 1, 2, 3, 4, 5
FLT_MIN = 1.1754943508222875e-38  # the unigram model's floor for the largest score
FLT_MAX = 3.4028234663852886e38  # its smallest NORMAL score where there is none
SPACE = "▁"  # kSpaceSymbol


@dataclass(frozen=True)
class Piece:
    piece: str = ""
    score: float = 0.0
    type: int = NORMAL


@dataclass(frozen=True)
class TrainerSpec:
    model_type: int = UNIGRAM
    split_by_whitespace: bool = True
    treat_whitespace_as_suffix: bool = False
    split_digits: bool = False
    byte_fallback: bool = False
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1
    unk_piece: str = "<unk>"


@dataclass(frozen=True)
class NormalizerSpec:
    name: str = ""
    precompiled_charsmap: bytes = b""
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True


@dataclass(frozen=True)
class ModelProto:
    pieces: tuple[Piece, ...] = ()
    trainer_spec: TrainerSpec = TrainerSpec()
    normalizer_spec: NormalizerSpec = NormalizerSpec()


# field number -> (name, kind) of each message's fields the port reads.
PIECE_FIELDS = {1: ("piece", "string"), 2: ("score", "float"), 3: ("type", PIECE_TYPES)}
TRAINER_FIELDS = {3: ("model_type", MODEL_TYPES), 22: ("split_by_whitespace", "bool"),
                  24: ("treat_whitespace_as_suffix", "bool"), 25: ("split_digits", "bool"),
                  35: ("byte_fallback", "bool"), 40: ("unk_id", "int32"), 41: ("bos_id", "int32"),
                  42: ("eos_id", "int32"), 43: ("pad_id", "int32"), 45: ("unk_piece", "string")}
NORMALIZER_FIELDS = {1: ("name", "string"), 2: ("precompiled_charsmap", "bytes"), 3: ("add_dummy_prefix", "bool"),
                     4: ("remove_extra_whitespaces", "bool"), 5: ("escape_whitespaces", "bool")}


# ---- the wire format -----------------------------------------------------------

def _varint(buf: bytes, pos: int) -> tuple[int, int]:
    out = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("a varint runs past the end of the message")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if b < 0x80:
            return out, pos
        shift += 7
        if shift >= 70:
            raise ValueError("a varint longer than 10 bytes")


def _take(buf: bytes, pos: int, n: int) -> tuple[bytes, int]:
    if pos + n > len(buf):
        raise ValueError(f"a {n}-byte field runs past the end of the message")
    return buf[pos : pos + n], pos + n


def _field(buf: bytes, pos: int) -> tuple[int, int, int | bytes | None, int]:
    """(number, wire type, value, next position) of the field at ``pos``; a
    group's value is None (skipped to its end)."""
    key, pos = _varint(buf, pos)
    number, wire = key >> 3, key & 7
    if number == 0:
        raise ValueError("field number 0")
    if wire == VARINT:
        value, pos = _varint(buf, pos)
    elif wire == FIXED64:
        value, pos = _take(buf, pos, 8)
    elif wire == LENGTH:
        n, pos = _varint(buf, pos)
        value, pos = _take(buf, pos, n)
    elif wire == FIXED32:
        value, pos = _take(buf, pos, 4)
    elif wire == START_GROUP:
        while True:
            if pos >= len(buf):
                raise ValueError(f"group {number} is not closed")
            inner, inner_wire, _, pos = _field(buf, pos)
            if inner_wire == END_GROUP:
                if inner != number:
                    raise ValueError(f"group {number} closed as {inner}")
                break
        value = None
    elif wire == END_GROUP:
        value = None
    else:
        raise ValueError(f"wire type {wire} of field {number}")
    return number, wire, value, pos


def fields(buf: bytes) -> Iterator[tuple[int, int, int | bytes | None]]:
    """(number, wire type, value) of each field of a message: an int for a
    varint, the bytes of anything else."""
    pos = 0
    while pos < len(buf):
        number, wire, value, pos = _field(buf, pos)
        if wire == END_GROUP:
            raise ValueError(f"end of group {number} outside a group")
        yield number, wire, value


def _int32(v: int) -> int:
    return ((v & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def _message(buf: bytes, table: dict, into):
    """``into`` (a dataclass) with the fields of ``table`` that ``buf`` sets."""
    got = {}
    for number, wire, value in fields(buf):
        if number not in table:
            continue
        name, kind = table[number]
        want = LENGTH if kind in ("string", "bytes") else FIXED32 if kind == "float" else VARINT
        if wire != want:
            continue  # protobuf keeps a field of another wire type as an unknown field
        if kind == "string":
            got[name] = value.decode("utf-8")
        elif kind == "bytes":
            got[name] = bytes(value)
        elif kind == "float":
            (got[name],) = struct.unpack("<f", value)
        elif kind == "bool":
            got[name] = value != 0
        elif kind == "int32":
            got[name] = _int32(value)
        elif _int32(value) in kind:  # an enum: a value outside it leaves the field as it was
            got[name] = _int32(value)
    return replace(into, **got)


def parse_model(buf: bytes) -> ModelProto:
    """The fields the port reads of a serialized ``ModelProto``."""
    pieces, trainer, normalizer = [], TrainerSpec(), NormalizerSpec()
    for number, wire, value in fields(buf):
        if wire != LENGTH:
            continue
        if number == 1:
            pieces.append(_message(value, PIECE_FIELDS, Piece()))
        elif number == 2:
            trainer = _message(value, TRAINER_FIELDS, trainer)
        elif number == 3:
            normalizer = _message(value, NORMALIZER_FIELDS, normalizer)
    return ModelProto(tuple(pieces), trainer, normalizer)


def read_model(path: str) -> ModelProto:
    """A sentencepiece ``.model`` file's fields (``parse_model``)."""
    with open(path, "rb") as f:
        return parse_model(f.read())


# ---- the encoder -----------------------------------------------------------------

class SentencePieceEncoder:
    """``SentencePieceProcessor``'s ``encode(text, out_type=str)`` and
    ``PieceToId`` over a parsed model.  WORD and CHAR models raise
    ``NotImplementedError``."""

    def __init__(self, proto: ModelProto):
        spec, norm = proto.trainer_spec, proto.normalizer_spec
        if spec.model_type not in (UNIGRAM, BPE):
            raise NotImplementedError(f"model_type {MODEL_TYPES[spec.model_type]}: the port encodes with UNIGRAM "
                                      f"and BPE sentencepiece models only")
        self.proto = proto
        self.bpe = spec.model_type == BPE
        self.byte_fallback = spec.byte_fallback
        self.ids: dict[str, int] = {}  # NORMAL, USER_DEFINED and UNUSED pieces: the model's
        self.reserved: dict[str, int] = {}  # CONTROL, UNKNOWN and BYTE pieces
        self.unk_id = -1
        for i, p in enumerate(proto.pieces):
            table = self.ids if p.type in (NORMAL, USER_DEFINED, UNUSED) else self.reserved
            if p.piece in table:
                raise ValueError(f"piece {p.piece!r} is already defined")
            table[p.piece] = i
            if p.type == UNKNOWN:
                if self.unk_id >= 0:
                    raise ValueError("unk is already defined")
                self.unk_id = i
            if p.type == BYTE and not spec.byte_fallback:
                raise ValueError(f"byte piece {p.piece!r} is found although byte_fallback is false")
        if self.unk_id < 0:
            raise ValueError("unk is not defined")
        self.types = [p.type for p in proto.pieces]
        self.scores = [p.score for p in proto.pieces]
        user = [p.piece for p in proto.pieces if p.type == USER_DEFINED]
        self._user: dict[str, list[str]] = {}  # first character -> user-defined pieces, longest first
        for p in sorted(user, key=len, reverse=True):
            self._user.setdefault(p[0], []).append(p)
        self.unigram = None
        if not self.bpe:
            normal = [p.score for p in proto.pieces if p.type == NORMAL]
            top = max([FLT_MIN, *normal])
            self.unigram = Unigram([(p.piece, p.score) if p.type == NORMAL
                                    else (p.piece, len(p.piece.encode("utf-8")) * top - 0.1) if p.type == USER_DEFINED
                                    else (None, p.score) for p in proto.pieces],
                                   self.unk_id, fuse_unk=False, min_score=min(normal, default=FLT_MAX))

        self.norm = norm
        self.suffix = spec.treat_whitespace_as_suffix
        self.ws = SPACE if norm.escape_whitespaces else " "
        self.charsmap = Charsmap(norm.precompiled_charsmap) if norm.precompiled_charsmap else None
        # Where no chunk the normalizer emits holds two spaces, its whitespace
        # rules act on the joined text, and ASCII text maps through a table.
        values = [] if self.charsmap is None else self.charsmap.strings.split(b"\0")
        self._joined_ok = not any(b"  " in v for v in values) and not any("  " in p for p in user)
        self._ascii = None if self.charsmap is None else self.charsmap.ascii_table()
        if self._ascii is not None:
            self._ascii_spaces = "".join(chr(c) for c, v in self._ascii.items() if v == " ") + (
                " " if 32 not in self._ascii else "")
        self._user_re = re.compile("|".join(map(re.escape, sorted(user, key=len, reverse=True)))) if user else None
        ws = re.escape(self.ws)
        local = re.compile(f"[^{ws}]*{ws}*" if self.suffix else f"{ws}*[^{ws}]*")
        self.word_local = all(local.fullmatch(p) for p in self.ids)
        self._words = re.compile(f"[^{ws}]+{ws}*|{ws}+" if self.suffix else f"{ws}*[^{ws}]+|{ws}+")
        self._memo: dict[str, tuple[list[str], list[int], bool]] = {}

    @classmethod
    def from_file(cls, path: str) -> "SentencePieceEncoder":
        return cls(read_model(path))

    def __len__(self) -> int:
        return len(self.proto.pieces)

    def piece_to_id(self, piece: str) -> int:
        """``PieceToId``: a CONTROL, UNKNOWN or BYTE piece's id, else the
        model's, else the unknown id."""
        got = self.reserved.get(piece)
        if got is None:
            got = self.ids.get(piece, self.unk_id)
        return got

    # ---- normalizer --------------------------------------------------------------

    def _user_at(self, text: str, i: int) -> int:
        """The length of the longest user-defined piece at ``text[i:]``, or 0."""
        for p in self._user.get(text[i], ()):
            if text.startswith(p, i):
                return len(p)
        return 0

    def _chunks(self, text: str) -> list[str]:
        """What the normalizer makes of each position in turn (``NormalizePrefix``)."""
        out = []
        i, n = 0, len(text)
        while i < n:
            m = self._user_at(text, i) if self._user else 0
            if m:
                out.append(text[i : i + m])
                i += m
                continue
            got = None if self.charsmap is None else self.charsmap.longest(text, i)
            if got is None:
                out.append(text[i])
                i += 1
            else:
                out.append(got[1])
                i += got[0]
        return out

    def _whitespace(self, chunks: list[str]) -> str:
        """``Normalizer::Normalize``'s loop over the chunks."""
        norm, ws = self.norm, self.ws
        remove = norm.remove_extra_whitespaces
        k = 0
        if remove:
            while k < len(chunks) and chunks[k] == " ":
                k += 1
        if k == len(chunks):
            return ""
        out = [ws] if norm.add_dummy_prefix and not self.suffix else []
        prev_space = remove
        for sp in chunks[k:]:
            if prev_space:
                sp = sp.lstrip(" ")
            if sp:
                out.append(sp.replace(" ", ws))
                prev_space = sp.endswith(" ")
            prev_space = prev_space and remove
        return self._finish_ws("".join(out))

    def _finish_ws(self, s: str) -> str:
        if self.norm.remove_extra_whitespaces:
            s = s.rstrip(self.ws)
        if self.norm.add_dummy_prefix and self.suffix:
            s += self.ws
        return s

    def _joined(self, s: str, nonempty: bool) -> str:
        """``_whitespace`` on the joined chunks ``s``, where no chunk holds two
        spaces (``nonempty``: some chunk is not a lone space)."""
        norm = self.norm
        if not nonempty:
            return ""
        if norm.remove_extra_whitespaces:
            s = re.sub(" {2,}", " ", s.lstrip(" "))
        s = s.replace(" ", self.ws)
        if norm.add_dummy_prefix and not self.suffix:
            s = self.ws + s
        return self._finish_ws(s)

    def normalize(self, text: str) -> str:
        """The text the model reads."""
        if not text:
            return ""
        remove = self.norm.remove_extra_whitespaces
        if self._joined_ok and (self._user_re is None or self._user_re.search(text) is None):
            if self.charsmap is None:
                return self._joined(text, bool(text.lstrip(" ")) if remove else True)
            if self._ascii is not None and text.isascii():
                return self._joined(text.translate(self._ascii),
                                    bool(text.lstrip(self._ascii_spaces)) if remove else True)
        return self._whitespace(self._chunks(text))

    # ---- models --------------------------------------------------------------------

    def _bpe(self, word: str) -> list[tuple[str, int]]:
        """``bpe_model.cc``'s ``Encode`` over ``word``: (piece, id)."""
        syms, frozen = [], []
        i = 0
        while i < len(word):
            m = self._user_at(word, i) if self._user else 0
            syms.append(word[i : i + (m or 1)])
            frozen.append(bool(m))
            i += m or 1
        n = len(syms)
        nxt = [*range(1, n), -1]
        prev = [-1, *range(n - 1)]
        ids, types, scores = self.ids, self.types, self.scores
        rev_merge: dict[str, tuple[str, str]] = {}
        agenda: list[tuple[float, int, int, int]] = []  # (-score, left, right, joined length)

        def add(left: int, right: int) -> None:
            if left < 0 or right < 0 or frozen[left] or frozen[right]:
                return
            piece = syms[left] + syms[right]
            i = ids.get(piece)
            if i is None:
                return
            heappush(agenda, (-scores[i], left, right, len(piece)))
            if types[i] == UNUSED:
                rev_merge[piece] = (syms[left], syms[right])

        for k in range(n - 1):
            add(k, k + 1)
        while agenda:
            _, left, right, size = heappop(agenda)
            if not syms[left] or not syms[right] or len(syms[left]) + len(syms[right]) != size:
                continue
            syms[left] += syms[right]
            nxt[left] = nxt[right]
            if nxt[right] >= 0:
                prev[nxt[right]] = left
            syms[right] = ""
            add(prev[left], left)
            add(left, nxt[left])
        out: list[tuple[str, int]] = []

        def resegment(w: str) -> None:
            i = self.piece_to_id(w)
            if types[i] != UNUSED or w not in rev_merge:
                out.append((w, i))
                return
            resegment(rev_merge[w][0])
            resegment(rev_merge[w][1])

        for w in syms:
            if w:
                resegment(w)
        return out

    def _word(self, word: str) -> tuple[list[str], list[int], bool]:
        """The pieces of one word, their ids (the unknown id for an unknown
        piece) and whether none is unknown; memoised."""
        got = self._memo.get(word)
        if got is None:
            if self.bpe:
                found = self._bpe(word)
            else:
                ids = self.unigram.ids
                found = [(p, ids.get(p, self.unk_id)) for p in self.unigram.pieces(word)]
            ids = [i for _, i in found]
            got = ([p for p, _ in found], ids, self.unk_id not in ids)
            if len(word) < 256:
                if len(self._memo) >= 1 << 20:
                    self._memo.clear()
                self._memo[word] = got
        return got

    def encode(self, text: str) -> list[str]:
        """The pieces of ``text``, as ``encode(text, out_type=str)`` gives
        them."""
        normalized = self.normalize(text)
        if not normalized:
            return []
        words = self._words.findall(normalized) if self.word_local else [normalized]
        out: list[str] = []
        prev_unk = False
        for word in words:
            pieces, ids, known = self._word(word)
            if known:  # no unknown piece: nothing to fuse or to send to bytes
                out += pieces
                prev_unk = False
                continue
            for piece, i in zip(pieces, ids):
                unk = i == self.unk_id
                if unk and self.byte_fallback:
                    out += [f"<0x{b:02X}>" for b in piece.encode("utf-8")]
                elif unk and prev_unk:
                    out[-1] += piece
                else:
                    out.append(piece)
                prev_unk = unk
        return out

    def encode_ids(self, text: str) -> list[int]:
        """The ids of ``encode(text)`` (``PieceToId`` of each piece)."""
        return [self.piece_to_id(p) for p in self.encode(text)]



# ---- the slow tokenizers around a model ----------------------------------------

SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token", "cls_token", "mask_token")


class SlowTokenizer(JsonTokenizer):
    """What ``transformers``' ``PreTrainedTokenizer`` does around a slow
    tokenizer's ``_tokenize`` (``tokenization_utils.py``), with
    ``JsonTokenizer``'s interface (``encode``, ``pad``, ``__call__``) and its
    truncation and padding:

    - the added tokens are ``tokenizer_config.json``'s ``added_tokens_decoder``
      at their ids, then each special token (``specials``' bos, eos, unk,
      sep, pad, cls and mask, then ``additional_special_tokens``) not yet
      added, at its id in ``vocab`` or, where ``vocab`` lacks it, past it
      (``_add_tokens``);
    - under ``do_lower_case`` every character but those of the special
      tokens is lowercased (``tokenize``);
    - the added tokens are split out of the text, leftmost-longest, and each
      piece between them goes through ``_tokenize`` alone;
    - a token is its added token's id, else ``_convert``'s;
    - ``single`` / ``pair`` are ``build_inputs_with_special_tokens``'s
      templates; padding is on the right."""

    def __init__(self, vocab: dict[str, int], specials: dict[str, str | None], config: dict,
                 single: Template, pair: Template):
        decoder = config.get("added_tokens_decoder", {})
        added = {}
        for i, t in decoder.items():
            tok = dict(t) if isinstance(t, dict) else {"content": str(t)}
            added[tok["content"]] = {**tok, "id": int(i)}
        current = {**vocab, **{c: t["id"] for c, t in added.items()}}
        new = len(current)
        extra = [special_token(t) for t in config.get("additional_special_tokens", [])]
        named = [specials[k] for k in SPECIAL_KEYS if specials.get(k)] + extra
        for content in dict.fromkeys(named):
            if content in added:
                continue
            if content not in current:
                current[content] = new
                new += 1
            added[content] = {"content": content, "id": current[content], "special": True}
        self.added = {c: t["id"] for c, t in added.items()}
        self.raw_tokens = AddedTokens(list(added.values()))
        self.vocab = {**vocab, **self.added}
        self.pad_id = self.vocab.get(specials["pad_token"]) if specials.get("pad_token") else None
        self.padding_side = config.get("padding_side", "right")
        self.single, self.pair = single, pair
        self._lower = None
        if config.get("do_lower_case"):
            keep = [*named, *(c for c, t in added.items() if t.get("special"))]
            keep += [c for c, t in added.items() if not t.get("special") and t.get("normalized", True)]
            self._lower = re.compile("(" + "|".join(map(re.escape, dict.fromkeys(keep))) + ")|(.+?)")

    def _tokenize(self, text: str) -> list[str]:
        raise NotImplementedError

    def _convert(self, token: str) -> int:
        raise NotImplementedError

    def tokenize(self, text: str) -> list[int]:
        """The ids of ``text``, without the template's special tokens."""
        if self._lower is not None:
            text = self._lower.sub(lambda m: m.group(1) or m.group(2).lower(), text)
        ids: list[int] = []
        added, convert = self.added, self._convert
        for (piece, _), tok in self.raw_tokens.split((text, True)):
            if tok is not None:
                ids.append(tok)
            else:
                ids += [added[t] if t in added else convert(t) for t in self._tokenize(piece)]
        return ids
