"""The port's ``tokenizer.json`` reader (``tokenizer_json.py``, with
``bpe.py``, ``unigram.py`` and ``charsmap.py``) against ``transformers``'
fast tokenizers loaded from the same directory, as ``JaxSentenceEncoderRM``
/ ``JaxCrossEncoderReranker`` load them, id for id:

- byte-level BPE (``RobertaTokenizerFast`` over a seeded ``vocab.json`` /
  ``merges.txt``), through ``tokenizer.json`` and through the two vocab files
  alone;
- Unigram (``XLMRobertaTokenizerFast(tokenizer_object=...)`` over a seeded
  vocabulary with tied scores, ``Metaspace`` and a ``Precompiled`` charsmap;
  ``AlbertTokenizerFast`` with ``NFKD``, ``StripAccents`` and ``Lowercase``
  before the charsmap and ``$B:1`` in its template);
- sentencepiece BPE (``BigBirdTokenizerFast`` with ``fuse_unk`` and
  ``SpmConverter``'s normalizer); RoFormer's and RoBERTa-PreLayerNorm's
  directories (a ``BertTokenizer``, byte-level BPE);
- a RoFormer directory whose tokenizer is ``RoFormerTokenizer`` (jieba) is
  refused, as the reference fails to build it without ``rjieba``;
- WordPiece through ``tokenizer.json`` (``DistilBertTokenizerFast``,
  ``ElectraTokenizerFast``), equal to the ``vocab.txt`` path;
- pairs, ``longest_first`` truncation and both padding modes;
- the charsmap against ``tokenizers.normalizers.Precompiled`` on a blob the
  test builds, the Unigram model against ``tokenizers``' on ties and
  unknowns, BPE merges by rank, and the components the port does not read."""

import json
import os
import shutil

import numpy as np
import pytest

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

from torch_families import CHARSMAP, FAMILIES, seeded_texts, seeded_words, write_tokenizer  # noqa: E402

from lotus_tpu_torch.models import JsonTokenizer, WordPieceTokenizer, load_tokenizer  # noqa: E402
from lotus_tpu_torch.models.bpe import BPE, byte_level_words  # noqa: E402
from lotus_tpu_torch.models.charsmap import Charsmap, build_charsmap  # noqa: E402
from lotus_tpu_torch.models.unigram import Unigram  # noqa: E402

TRICKY = [
    "", " ", "   ", "  hello", "hello <mask> world", "<mask>", "a<mask>b", "x  <mask>  y", "<s>hi</s> [CLS] [SEP]",
    "Ａｂ①② ㍿ ﬁne", "é Ａ́ Ａ́́ é", "日本語", "😀👍🏽 👨‍👩‍👧 🇫🇷🇩🇪", "tab\there\nnewline\r\nx", "``quoted''",
    "a   b", "　x　　y", "don't IT'S they'll 's", "12345 3.14 ³½", "naïve café", "한국어 한",
    "\x00\x01 ctrl \x7f", "﻿bom", "x​y", "a\xa0b  c", "Hello, WORLD! ¿qué?", "x" * 120,
]


@pytest.fixture(scope="module", params=FAMILIES)
def pair(request, tmp_path_factory):
    """(the fast tokenizer, the port's, texts, directory) for one family."""
    d = str(tmp_path_factory.mktemp(request.param))
    write_tokenizer(d, request.param, seed=1)
    texts = TRICKY + seeded_texts(2, 120, seeded_words(1, 200))
    return transformers.AutoTokenizer.from_pretrained(d), load_tokenizer(d), texts, d


def test_single_texts_equal_ids(pair):
    ref, port, texts, _ = pair
    assert isinstance(port, JsonTokenizer)
    for text in texts:
        assert port.encode([text])[0] == ref(text)["input_ids"], repr(text)
    assert port.pad_id == ref.pad_token_id


@pytest.mark.parametrize("max_length", [5, 8, 9, 33])
@pytest.mark.parametrize("padding", [True, "max_length"])
def test_batches_truncated_and_padded(pair, max_length, padding):
    """Singles and pairs, truncated (``longest_first`` for pairs, counting
    the special tokens the template adds) and padded to the longest or to
    ``max_length`` with the tokenizer's own pad id: ids, mask and (where the
    fast tokenizer returns them) token types equal, int64."""
    ref, port, texts, _ = pair
    first, second = texts[:60], texts[60:120]
    for args in ((first,), (first, second)):
        want = ref(*args, padding=padding, truncation=True, max_length=max_length, return_tensors="np")
        got = port(*args, padding=padding, max_length=max_length)
        for key in ("input_ids", "token_type_ids", "attention_mask"):
            if key in want:
                assert got[key].dtype == np.int64 and np.array_equal(got[key], want[key]), (len(args), key)


@pytest.mark.parametrize("family", ["distilbert", "electra"])
def test_wordpiece_json_equals_vocab_txt(tmp_path, family):
    """A WordPiece ``tokenizer.json`` gives the ``vocab.txt`` path's ids,
    singles and pairs."""
    write_tokenizer(str(tmp_path), family, seed=1)
    port, plain = JsonTokenizer.from_dir(str(tmp_path)), WordPieceTokenizer.from_dir(str(tmp_path))
    texts = TRICKY + seeded_texts(5, 60, seeded_words(1, 200))
    half = len(texts) // 2
    for a, b in ((texts, None), (texts[:half], texts[half : 2 * half])):
        assert port.encode(a, b, max_length=24) == plain.encode(a, b, max_length=24)


def test_bpe_from_vocab_json_and_merges_txt(tmp_path):
    """A directory with only ``vocab.json`` + ``merges.txt`` (and the
    config) gives ``RobertaTokenizerFast``'s ids."""
    full = str(tmp_path / "full")
    ref = write_tokenizer(full, "roberta", seed=3)
    bare = tmp_path / "bare"
    bare.mkdir()
    for name in ("vocab.json", "merges.txt"):
        shutil.copy(os.path.join(full, name), bare / name)
    port = load_tokenizer(str(bare))
    texts = TRICKY + seeded_texts(4, 60, seeded_words(3, 100))
    for text in texts:
        assert port.encode([text])[0] == ref(text)["input_ids"], repr(text)
    assert port.encode(texts[:9], texts[9:18], max_length=20) == ref(texts[:9], texts[9:18], truncation=True,
                                                                     max_length=20)["input_ids"]
    assert port.pad_id == 1


def test_load_tokenizer_order_and_missing(tmp_path):
    d = str(tmp_path / "wp")
    write_tokenizer(d, "distilbert")
    texts = TRICKY + seeded_texts(6, 20, seeded_words(0, 100))
    from_json = load_tokenizer(d).encode(texts)
    os.remove(os.path.join(d, "tokenizer.json"))
    assert load_tokenizer(d).encode(texts) == from_json  # vocab.txt
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        load_tokenizer(str(tmp_path))


def test_charsmap_equals_precompiled():
    """``charsmap.py`` against ``tokenizers``' ``Precompiled`` on a blob
    ``build_charsmap`` writes: keys met whole and inside graphemes of several characters
    (a mapped letter with combining marks, under and over 6 bytes), emoji
    sequences, Hangul jamo, regional indicators and CR LF."""
    blob = build_charsmap(CHARSMAP)
    ref = tokenizers.normalizers.Precompiled(blob)
    port = Charsmap(blob)
    pool = [*CHARSMAP, "a", "b", " ", "e", "́", "̈", "‍", "‌", "😀", "👨", "🏽", "\U0001F1EB",
            "\U0001F1F7", "ᄀ", "ᅡ", "ᆨ", "한", "\r", "\n", "\r\n", "\x00", "日", "ß", "️", "क",
            "्", "ि"]
    rng = np.random.default_rng(0)
    texts = ["", "abc", "Ａ́", "Ａ́́", "é", "é́", "①̈", "\r\n①", "x　y"]
    texts += ["".join(rng.choice(pool, rng.integers(1, 12))) for _ in range(2000)]
    for text in texts:
        assert port.normalize(text) == ref.normalize_str(text), repr(text)


def test_charsmap_rejects_short_blobs():
    for blob in (b"", b"\x08\x00\x00\x00\x00"):
        with pytest.raises(ValueError, match="charsmap"):
            Charsmap(blob)


def test_unigram_ties_and_unknowns():
    """Pieces of equal score: the library's Viterbi keeps the first path
    that reaches a node; unknown characters score the lowest piece minus 10
    and fuse (the library always fuses; ``fuse_unk=False`` keeps one unknown
    a character)."""
    vocab = [("<unk>", 0.0), ("a", -1.0), ("b", -1.0), ("ab", -2.0), ("ba", -2.0), ("aba", -3.0), ("c", -1.5),
             ("abc", -3.5), ("bc", -2.5), ("▁", -1.0), ("▁a", -1.0), ("▁ab", -2.0), ("cc", -3.0), ("xy", -30.0)]
    ref = tokenizers.models.Unigram(vocab, unk_id=0, byte_fallback=False)
    port = Unigram(vocab, 0)
    rng = np.random.default_rng(1)
    words = ["", "ab", "aba", "abab", "ababa", "abc", "bcab", "▁abab", "zz", "azzb", "zzaz", "xy", "xyz", "▁zq"]
    words += ["".join(rng.choice(list("abc▁zqxy"), rng.integers(1, 12))) for _ in range(1500)]
    for w in words:
        assert port(w) == [t.id for t in ref.tokenize(w)], repr(w)
    assert Unigram(vocab, 0, fuse_unk=False)("azzbz") == [1, 0, 0, 2, 0]


def test_unigram_matches_the_library_model():
    vocab = [("<unk>", 0.0), ("a", -1.0), ("ab", -2.0)]
    ref = tokenizers.models.Unigram(vocab, unk_id=0, byte_fallback=False)
    assert [t.id for t in ref.tokenize("abzzab")] == Unigram(vocab, 0)("abzzab") == [2, 0, 2]
    with pytest.raises(NotImplementedError, match="byte_fallback"):
        Unigram(vocab, 0, byte_fallback=True)


def test_bpe_merges_by_rank():
    """Seeded merges (some of whose results merge again at a lower rank
    than the merge that made them) applied as the library applies them."""
    rng = np.random.default_rng(2)
    alphabet = list("abcd")
    vocab = {c: i for i, c in enumerate(alphabet)}
    merges = []
    for _ in range(40):
        a, b = rng.choice(list(vocab), 2)
        if len(a) + len(b) <= 5 and (a, b) not in merges:
            merges.append((a, b))
            vocab.setdefault(a + b, len(vocab))
    rng.shuffle(merges)
    ref = tokenizers.models.BPE(vocab, merges)
    port = BPE(vocab, merges)
    for _ in range(1500):
        w = "".join(rng.choice(alphabet, rng.integers(1, 14)))
        assert port(w) == [t.id for t in ref.tokenize(w)], w


def test_byte_level_pre_tokenizer():
    ref = tokenizers.pre_tokenizers.ByteLevel(add_prefix_space=False)
    for text in TRICKY:
        assert byte_level_words(text) == [w for w, _ in ref.pre_tokenize_str(text)], repr(text)


def test_unported_components_raise(tmp_path):
    d = str(tmp_path)
    write_tokenizer(d, "distilbert")
    with open(os.path.join(d, "tokenizer.json"), encoding="utf-8") as f:
        spec = json.load(f)
    for part, kind in (("normalizer", "Nmt"), ("pre_tokenizer", "Digits"), ("model", "WordLevel"),
                       ("post_processor", "Sequence")):
        with pytest.raises(NotImplementedError, match=kind):
            JsonTokenizer({**spec, part: {**(spec[part] or {}), "type": kind}})


def test_nfkd_equals_the_library():
    ref = tokenizers.normalizers.NFKD()
    port = JsonTokenizer({"normalizer": {"type": "NFKD"}, "model": {"type": "WordPiece", "vocab": {"[UNK]": 0},
                                                                    "unk_token": "[UNK]"}})._normalize
    for text in TRICKY + ["ﬀ ﬃ ﬁ", "Ⅻ ½ ㎏ ㍿", "Å Ω K", "ｶﾞ ｱ", "x²₃", "ǅ ǈ", "한글 ᄀ"]:
        assert port(text) == ref.normalize_str(text), repr(text)


@pytest.mark.parametrize("where", ["tokenizer_config", "config_class", "model_type"])
def test_roformer_jieba_tokenizer_is_refused(tmp_path, where):
    """``RoFormerTokenizerFast`` cuts words with jieba, which
    ``tokenizer.json`` does not record (it holds a ``BertPreTokenizer``):
    a directory whose tokenizer is RoFormer's is refused, never read as
    WordPiece, whether ``tokenizer_config.json`` or ``config.json`` names
    the class or a ``roformer`` model names none; the reference's
    ``AutoTokenizer`` fails there too, without ``rjieba``."""
    d = str(tmp_path)
    write_tokenizer(d, "roformer")
    with open(os.path.join(d, "tokenizer_config.json"), encoding="utf-8") as f:
        tok_config = json.load(f)
    tok_config.pop("tokenizer_class")
    model = {"model_type": "roformer"}
    if where == "tokenizer_config":
        tok_config["tokenizer_class"] = "RoFormerTokenizer"
    elif where == "config_class":
        model["tokenizer_class"] = "RoFormerTokenizerFast"
    for name, obj in (("tokenizer_config.json", tok_config), ("config.json", model)):
        with open(os.path.join(d, name), "w", encoding="utf-8") as f:
            json.dump(obj, f)
    with pytest.raises(NotImplementedError, match="jieba"):
        load_tokenizer(d)
    with pytest.raises(NotImplementedError, match="jieba"):
        JsonTokenizer.from_vocab_txt(d)
    with pytest.raises(ImportError, match="rjieba"):
        transformers.AutoTokenizer.from_pretrained(d)
