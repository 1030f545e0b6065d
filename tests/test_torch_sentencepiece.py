"""The port's sentencepiece ``.model`` reader and encoder
(``lotus_tpu_torch/models/sentencepiece.py``) held in a chain, since
neither machine has the ``sentencepiece`` package:

- the reader against protobuf's parse (``transformers``'
  ``sentencepiece_model_pb2_new``) of seeded files: every piece type, both
  model types, every normalizer flag set, unset and absent, negative
  int32s, unknown fields of every wire type, a message given twice, an
  enum value outside its enum; WORD and CHAR models raise;
- the card tests' writer (``torch_card_files.py``: the card machine has
  no protobuf): its files parse under protobuf to the fields it was given;
- the encoder against the ``tokenizers`` models that ``SpmConverter``
  builds from the same proto (its Unigram, and a BPE over
  ``generate_merges``' merges, as ``SentencePieceExtractor`` makes them), id
  for id on seeded and ``hypothesis`` texts, with and without a charsmap;
- the cases where sentencepiece and that conversion are documented to
  differ, with ids written by hand, each test's docstring giving the
  reason; the port follows sentencepiece.
"""

import numpy as np
import pytest

transformers = pytest.importorskip("transformers")
hypothesis = pytest.importorskip("hypothesis")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from torch_card_files import spm_model_bytes, spm_pieces  # noqa: E402
from torch_families import CHARSMAP, converted, seeded_texts, seeded_words, spm_proto  # noqa: E402
from transformers.utils import sentencepiece_model_pb2_new as pb  # noqa: E402

from lotus_tpu_torch.models.charsmap import build_charsmap  # noqa: E402
from lotus_tpu_torch.models.sentencepiece import (  # noqa: E402
    ModelProto, NormalizerSpec, SentencePieceEncoder, TrainerSpec, parse_model,
)

HEAD = (("<unk>", 2), ("<s>", 3), ("</s>", 3))
TEXTS = seeded_texts(1, 200, seeded_words(0, 200), 0, 30) + [
    "", " ", "   ", "Hello, WORLD!", "  leading and trailing  ", "a  b   c", "ＡＢ ① ㍿ ﬁne", "日本語 中文",
    "😀😀 and 😀", "ét", "tab\there", "x\x01y\x07z", "naïve café"]
BLOB = build_charsmap(CHARSMAP)


def trainer_fields(spec) -> dict:
    return {k: getattr(spec, k) for k in TrainerSpec.__dataclass_fields__}


def normalizer_fields(spec) -> dict:
    return {k: getattr(spec, k) for k in NormalizerSpec.__dataclass_fields__}


def assert_same_fields(data: bytes) -> ModelProto:
    """The port's parse of ``data`` equals protobuf's, field for field."""
    ref = pb.ModelProto()
    ref.ParseFromString(data)
    got = parse_model(data)
    assert [(p.piece, p.score, p.type) for p in got.pieces] == [(p.piece, p.score, p.type) for p in ref.pieces]
    assert vars(got.trainer_spec) == trainer_fields(ref.trainer_spec)
    assert vars(got.normalizer_spec) == normalizer_fields(ref.normalizer_spec)
    return got


def encoder(proto) -> SentencePieceEncoder:
    return SentencePieceEncoder(parse_model(proto.SerializeToString()))


# ---- the reader ------------------------------------------------------------------

FLAGS = ("add_dummy_prefix", "remove_extra_whitespaces", "escape_whitespaces")


@pytest.mark.parametrize("model_type", ["unigram", "bpe"])
@pytest.mark.parametrize("flags", ["absent", "set", "unset"])
def test_reader_matches_protobuf(model_type, flags):
    """Every piece type, both model types, and the normalizer flags absent
    (proto2's declared default, true, not zero), set and unset."""
    head = (("<unk>", 2), ("<s>", 3), ("</s>", 3), ("<unused>", 5), ("<mask>", 4))
    norm = {} if flags == "absent" else dict.fromkeys(FLAGS, flags == "set")
    proto = spm_proto(2, model_type, head=head, byte_fallback=True, blob=BLOB, n_words=40, **norm)
    proto.normalizer_spec.name = "nmt_nfkc"
    got = assert_same_fields(proto.SerializeToString())
    assert {p.type for p in got.pieces} == {1, 2, 3, 4, 5, 6}
    assert got.trainer_spec.model_type == (2 if model_type == "bpe" else 1)
    assert [getattr(got.normalizer_spec, f) for f in FLAGS] == [flags != "unset"] * 3
    assert got.normalizer_spec.precompiled_charsmap == BLOB


def test_reader_trainer_fields_and_defaults():
    """An empty model takes every declared default (``pad_id`` -1, the
    whitespace flags true); set ones, a negative int32 (ten varint bytes)
    and the strings read back."""
    assert parse_model(b"") == ModelProto()
    assert_same_fields(b"")
    proto = spm_proto(3, "unigram", head=HEAD, n_words=10)
    t = proto.trainer_spec
    t.unk_id, t.bos_id, t.eos_id, t.pad_id, t.unk_piece = 0, -1, 2, -7, "<UNK>"
    t.split_digits, t.split_by_whitespace, t.treat_whitespace_as_suffix = True, False, True
    got = assert_same_fields(proto.SerializeToString())
    assert (got.trainer_spec.pad_id, got.trainer_spec.bos_id, got.trainer_spec.unk_piece) == (-7, -1, "<UNK>")


def test_reader_skips_unknown_fields_as_protobuf_does():
    """Unknown fields of every wire type (varint, fixed64, length, group,
    fixed32) at the top and inside each message are skipped; a field of a
    known number but another wire type is skipped; a scalar given twice
    keeps the last value and a message given twice merges; an enum value
    outside its enum leaves the field as it was."""
    def key(number, wire):
        return bytes([number << 3 | wire]) if number < 16 else bytes([(number << 3 | wire) & 0x7F | 0x80,
                                                                        (number << 3 | wire) >> 7])

    unknown = (key(15, 0) + b"\x96\x01" + key(14, 1) + bytes(8) + key(13, 2) + b"\x03abc"
               + key(12, 3) + key(1, 0) + b"\x01" + key(12, 4) + key(11, 5) + bytes(4))
    piece = key(1, 2) + b"\x02ab" + key(2, 5) + np.float32(-1.5).tobytes() + key(3, 0) + b"\x09"  # type 9: no enum
    trainer = key(3, 0) + b"\x02" + key(35, 0) + b"\x01" + key(40, 2) + b"\x01x" + key(3, 0) + b"\x07" + unknown
    normalizer = key(3, 0) + b"\x00" + unknown + key(3, 0) + b"\x01"
    trainer_again = key(42, 0) + b"\x05"
    data = (unknown + key(1, 2) + bytes([len(piece + unknown)]) + piece + unknown
            + key(2, 2) + bytes([len(trainer)]) + trainer + key(3, 2) + bytes([len(normalizer)]) + normalizer
            + key(2, 2) + bytes([len(trainer_again)]) + trainer_again + key(3, 0) + b"\x01")
    got = assert_same_fields(data)
    assert got.pieces[0].type == 1 and got.pieces[0].score == -1.5
    assert (got.trainer_spec.model_type, got.trainer_spec.byte_fallback, got.trainer_spec.eos_id) == (2, True, 5)
    assert got.normalizer_spec.add_dummy_prefix is True
    with pytest.raises(ValueError, match="past the end"):
        parse_model(data + b"\x1a\x05ab")


@pytest.mark.parametrize("model_type", [3, 4])
def test_word_and_char_models_raise(model_type):
    proto = spm_proto(4, "unigram", head=HEAD, n_words=10)
    proto.trainer_spec.model_type = model_type
    got = assert_same_fields(proto.SerializeToString())
    with pytest.raises(NotImplementedError, match="WORD" if model_type == 3 else "CHAR"):
        SentencePieceEncoder(got)


def test_chip_smoke_writer_parses_under_protobuf():
    """``torch_card_files.spm_model_bytes``, the writer the card tests use
    (the card machine has no protobuf), writes what protobuf parses back to
    the fields it was given, negative ids and the charsmap included; the
    seeded vocabulary holds most words whole and splits the rest in two."""
    words = seeded_words(5, 300)
    pieces = spm_pieces(words, 2000, 1, [("<unk>", 2), ("<pad>", 3)], byte_fallback=True)
    data = spm_model_bytes(pieces, byte_fallback=True, pad_id=1, bos_id=-1, eos_id=-1, charsmap=BLOB,
                           name="nmt_nfkc", remove_extra_whitespaces=False)
    ref = pb.ModelProto()
    ref.ParseFromString(data)
    assert [(p.piece, p.score, p.type) for p in ref.pieces] == [(p, np.float32(s), k) for p, s, k in pieces]
    t, n = ref.trainer_spec, ref.normalizer_spec
    assert (t.model_type, t.byte_fallback, t.unk_id, t.bos_id, t.eos_id, t.pad_id) == (1, True, 0, -1, -1, 1)
    assert (n.name, n.precompiled_charsmap, n.add_dummy_prefix, n.remove_extra_whitespaces,
            n.escape_whitespaces) == ("nmt_nfkc", BLOB, True, False, True)
    got = assert_same_fields(data)
    enc = SentencePieceEncoder(got)
    counts = [len(enc.encode(w)) for w in words if len(w) >= 4]
    assert np.mean(np.array(counts) == 1) > 0.6 and max(counts) <= 2


# ---- the encoder against the tokenizers conversion ---------------------------------

MODELS = {
    "unigram": dict(model_type="unigram"),
    "unigram-charsmap": dict(model_type="unigram", blob=BLOB),
    "bpe": dict(model_type="bpe"),
    "bpe-charsmap": dict(model_type="bpe", blob=BLOB),
}


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    proto = spm_proto(0, head=HEAD, **MODELS[request.param])
    return request.param, encoder(proto), converted(proto)


def agree(name: str, text: str) -> bool:
    """Whether ``text`` avoids the documented differences: whitespace other
    than a space at its end (the conversion's ``Strip`` takes any, the
    identity normalizer only spaces; the charsmap maps a tab and U+00A0 to
    a space)."""
    tail = text.rstrip(" \t\u00a0\u3000" if "charsmap" in name else " ")
    return tail == tail.rstrip()


def test_encoder_ids_equal_tokenizers(pair):
    name, enc, conv = pair
    checked = 0
    for text in TEXTS:
        if agree(name, text):
            assert enc.encode_ids(text) == conv.encode(text).ids, text
            checked += 1
    assert checked > 150


ALPHABET = [*"abcdefghijklmnopqrstuvwxyz\u00e9\u00fc\u00df\u00f1\u65e5\u672c\U0001F600!.,'09 ", "  ", "\t", "\x01",
            "\uff21", "\u2460", "\u3000", "\u01c5"]


@settings(max_examples=100, deadline=None, derandomize=True, database=None)
@given(chars=st.lists(st.sampled_from(ALPHABET), max_size=40))
def test_encoder_hypothesis_texts(pair, chars):
    """Accents, CJK, an emoji, control characters, runs of spaces, the
    charsmap's keys."""
    name, enc, conv = pair
    text = "".join(chars)
    if agree(name, text):
        assert enc.encode_ids(text) == conv.encode(text).ids, text


def test_fast_normalizer_equals_the_chunk_loop(pair):
    """The joined-text whitespace rules (no chunk holds two spaces) and the
    ASCII table give what ``Normalizer::Normalize``'s loop over each
    position's chunk gives."""
    _, enc, _ = pair
    for text in TEXTS + ["  a", "a  ", "\x00", " \t ", "a　　b"]:
        assert enc.normalize(text) == enc._whitespace(enc._chunks(text)), text


def test_word_by_word_equals_whole_text(pair):
    """No piece crosses a word's start, so the model run word by word gives
    what it gives over the whole normalized text."""
    _, enc, _ = pair
    assert enc.word_local
    want = [enc.encode(t) for t in TEXTS]
    enc.word_local = False
    try:
        assert [enc.encode(t) for t in TEXTS] == want
    finally:
        enc.word_local = True


# ---- where sentencepiece and the conversion differ (hand-written ids) ---------------

def tiny(model_type: str = "unigram", pieces=(), byte_fallback: bool = False, **norm) -> pb.ModelProto:
    """A hand-made model: ``<unk> <s> </s>``, the byte pieces under
    ``byte_fallback``, then ``pieces`` (piece, score, type)."""
    m = pb.ModelProto()
    for p, t in HEAD:
        m.pieces.add(piece=p, score=0.0, type=t)
    if byte_fallback:
        for b in range(256):
            m.pieces.add(piece=f"<0x{b:02X}>", score=0.0, type=6)
    for p, s, t in pieces:
        m.pieces.add(piece=p, score=s, type=t)
    m.trainer_spec.model_type = 2 if model_type == "bpe" else 1
    m.trainer_spec.byte_fallback = byte_fallback
    for k, v in norm.items():
        setattr(m.normalizer_spec, k, v)
    return m


UNI = [("▁a", -1.0, 1), ("▁b", -1.0, 1), ("▁", -2.0, 1), ("a", -3.0, 1), ("b", -3.0, 1), ("▁ab", -1.5, 1),
       ("<", -4.0, 1), (">", -4.0, 1), ("s", -4.0, 1), ("x", -4.0, 1), ("0", -4.0, 1), ("4", -4.0, 1),
       ("1", -4.0, 1), ("/", -4.0, 1)]


def test_trailing_space_symbol_is_dropped():
    """sentencepiece trims every trailing ``▁`` after escaping, a ``▁``
    typed in the text included (``normalizer.cc``); the conversion's
    ``Strip`` leaves it."""
    proto = tiny(pieces=UNI)
    enc, conv = encoder(proto), converted(proto)
    assert enc.encode("a▁") == ["▁a"] and enc.encode_ids("a▁") == [3]
    assert conv.encode("a▁").tokens == ["▁a", "▁"]


def test_remove_extra_whitespaces_false_keeps_spaces():
    """With ``remove_extra_whitespaces`` false a leading, repeated or trailing
    space stays (each a ``▁``); the conversion collapses and strips them
    whatever the flag says."""
    proto = tiny(pieces=UNI, remove_extra_whitespaces=False)
    enc, conv = encoder(proto), converted(proto)
    assert enc.encode(" a  b ") == ["▁", "▁a", "▁", "▁b", "▁"]
    assert enc.encode_ids(" a  b ") == [5, 3, 5, 4, 5]
    assert conv.encode(" a  b ").tokens == ["▁a", "▁b"]
    assert encoder(tiny(pieces=UNI)).encode(" a  b ") == ["▁a", "▁b"]


def test_add_dummy_prefix_false():
    """Without ``add_dummy_prefix`` no ``▁`` goes in front; the conversion's
    ``Metaspace`` prepends one anyway."""
    proto = tiny(pieces=UNI, add_dummy_prefix=False)
    enc, conv = encoder(proto), converted(proto)
    assert enc.encode("ab b") == ["a", "b", "▁b"] and enc.encode_ids("ab b") == [6, 7, 4]
    assert conv.encode("ab b").tokens == ["▁ab", "▁b"]


def test_escape_whitespaces_false():
    """Without ``escape_whitespaces`` a space stays a space in the pieces."""
    proto = tiny(pieces=[(" a", -1.0, 1), (" ", -2.0, 1), ("a", -3.0, 1)], escape_whitespaces=False)
    assert encoder(proto).encode("a  a") == [" a", " a"]


@pytest.mark.parametrize("model_type", ["unigram", "bpe"])
def test_user_defined_symbol_inside_a_word(model_type):
    """A user-defined piece is one piece wherever it stands (Unigram: its
    bonus score; BPE: a frozen symbol), and the word's other characters get
    no ``▁`` of their own; the conversion splits it out of the raw text as
    an added token, and ``Metaspace`` then prepends ``▁`` to the rest."""
    pieces = [("<sep>", 0.0, 4), *UNI] if model_type == "unigram" else [
        ("<sep>", 0.0, 4), ("▁a", -1.0, 1), ("▁b", -2.0, 1), ("▁", -3.0, 1), ("a", -4.0, 1), ("b", -5.0, 1),
        ("<", -6.0, 1), ("s", -7.0, 1), ("e", -8.0, 1), ("p", -9.0, 1), (">", -10.0, 1)]
    proto = tiny(model_type, pieces)
    enc, conv = encoder(proto), converted(proto)
    assert enc.encode("a<sep>b") == ["▁a", "<sep>", "b"] and enc.encode_ids("a<sep>b")[1] == 3
    assert conv.encode("a<sep>b").tokens == ["▁a", "<sep>", "▁b"]


def test_control_and_byte_pieces_are_never_read_from_text():
    """``<s>`` and ``<0x41>`` typed in the text are characters to
    sentencepiece (CONTROL and BYTE pieces are not in its model's trie); the
    conversion adds ``<s>`` as a special token and holds ``<0x41>`` as a
    Unigram piece."""
    proto = tiny(pieces=UNI, byte_fallback=True)
    enc, conv = encoder(proto), converted(proto)
    assert enc.encode("<s>") == ["▁", "<", "s", ">"]
    assert conv.encode("<s>").tokens == ["<s>"]
    assert enc.encode("<0x41>")[:3] == ["▁", "<", "0"] and len(enc.encode("<0x41>")) == 7
    assert conv.encode("<0x41>").tokens == ["▁", "<0x41>"]


@pytest.mark.parametrize("model_type", ["unigram", "bpe"])
def test_byte_fallback(model_type):
    """Under ``byte_fallback`` each unknown character becomes the pieces of
    its UTF-8 bytes (never fused); the conversion (``SpmConverter`` has no
    byte fallback) gives the unknown token."""
    proto = tiny(model_type, UNI, byte_fallback=True)
    enc, conv = encoder(proto), converted(proto)
    assert enc.encode("a😀é") == ["▁a", "<0xF0>", "<0x9F>", "<0x98>", "<0x80>", "<0xC3>", "<0xA9>"]
    assert enc.encode_ids("a😀")[1:] == [3 + 0xF0, 3 + 0x9F, 3 + 0x98, 3 + 0x80]
    assert conv.encode("a😀é").ids[1:] == [0]


def test_unknown_runs_fuse_into_one_piece():
    """Without byte fallback a run of unknown characters is one piece, the
    text it covers, whose id is the unknown id: in sentencepiece by
    ``PopulateSentencePieceText``'s merge, in the conversion by
    ``fuse_unk``: the same ids."""
    proto = tiny(pieces=UNI)
    enc, conv = encoder(proto), converted(proto)
    assert enc.encode("a 😀日 b") == ["▁a", "▁", "😀日", "▁b"]
    assert enc.encode_ids("a 😀日 b") == conv.encode("a 😀日 b").ids == [3, 5, 0, 4]


def test_bpe_unused_piece_is_split_back():
    """sentencepiece's BPE merges through an UNUSED piece and splits any
    UNUSED piece left at the end back into the pair that made it
    (``rev_merge``)."""
    proto = tiny("bpe", [("▁ab", -1.0, 1), ("▁a", -2.0, 5), ("▁", -3.0, 1), ("a", -4.0, 1), ("b", -5.0, 1)])
    enc = encoder(proto)
    assert enc.encode("ab") == ["▁ab"]
    assert enc.encode("a") == ["▁", "a"]


def test_unigram_user_defined_bonus_and_unused_pieces():
    """A USER_DEFINED piece scores its UTF-8 length times the largest NORMAL
    score (at least FLT_MIN) less 0.1, so it beats a cheaper NORMAL path; an
    UNUSED piece is never taken."""
    proto = tiny(pieces=[("▁", -1.0, 1), ("xy", 0.0, 4), ("x", -1.0, 1), ("y", -1.0, 1), ("▁xyz", -0.5, 5),
                         ("z", -1.0, 1)])
    assert encoder(proto).encode("xyz") == ["▁", "xy", "z"]


def test_charsmap_longest_key():
    """sentencepiece replaces the longest key at each position (``e`` and a
    combining acute accent becomes ``é``, and a second accent stays); the
    conversion's ``Precompiled`` looks up the whole grapheme cluster, and
    the shortest key that is a prefix of it (``e``) replaces all of it."""
    proto = tiny(pieces=[*UNI, ("\u00e9", -3.0, 1), ("\u0301", -3.0, 1)])
    proto.normalizer_spec.precompiled_charsmap = build_charsmap({"e\u0301": "\u00e9", "e": "E"})
    enc, conv = encoder(proto), converted(proto)
    assert enc.normalize("e\u0301\u0301") == "\u2581\u00e9\u0301" and enc.normalize("e") == "\u2581E"
    assert conv.normalizer.normalize_str("e\u0301\u0301") == "E"


def test_identity_keeps_trailing_no_break_space():
    """The identity normalizer trims only spaces at the end: a trailing
    U+00A0 stays (and is unknown here); the conversion's ``Strip`` takes any
    whitespace."""
    proto = tiny(pieces=UNI)
    enc, conv = encoder(proto), converted(proto)
    assert enc.encode("a  ") == ["▁a", "▁", " "]
    assert conv.encode("a  ").tokens == ["▁a"]


def test_piece_to_id():
    """``PieceToId``: CONTROL, UNKNOWN and BYTE pieces first, then the
    model's, else the unknown id; a model without an UNKNOWN piece, or with
    two, is refused."""
    enc = encoder(tiny(pieces=UNI, byte_fallback=True))
    assert [enc.piece_to_id(p) for p in ("<s>", "</s>", "<0x41>", "▁a", "missing", "<unk>")] == [1, 2, 3 + 0x41,
                                                                                                  259, 0, 0]
    no_unk = pb.ModelProto()
    no_unk.pieces.add(piece="a", score=-1.0)
    with pytest.raises(ValueError, match="unk is not defined"):
        encoder(no_unk)
    two = tiny(pieces=[("<unk2>", 0.0, 2)])
    with pytest.raises(ValueError, match="unk is already defined"):
        encoder(two)
