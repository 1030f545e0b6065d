"""The port's WordPiece tokenizer (``lotus_tpu_torch/models/wordpiece.py``)
against ``BertTokenizerFast`` loaded from the same checkpoint directory, as
``JaxSentenceEncoderRM`` / ``JaxCrossEncoderReranker`` load it: every id,
token type and mask bit must be equal, on single texts and pairs, over case
and accents, punctuation, CJK, control characters, unknown and over-long
words, ``""``, special tokens written in the text, ``longest_first``
truncation and both padding modes."""

import numpy as np
import pytest

transformers = pytest.importorskip("transformers")

from test_torch_checkpoints import VOCAB, seeded_vocab  # noqa: E402

from lotus_tpu_torch.models.wordpiece import WordPieceTokenizer  # noqa: E402

TEXTS = [
    "", "   ", "the cat sat on the mat", "Hello, World!", "THE Cat SAT",
    "Héllo WÖRLD façade naïve", "ΟΔΟΣ ςσ Σ", "İstanbul",
    "a\x0bb\x0cc\x1cd\x85e\xa0f g​h\x00i�j\tk\nl\rm\x7fn",
    "日本語abc 中文の", "x" * 101, "ab" * 50, "ab" * 40 + " " + "zz" * 51,
    "hello [SEP] the[CLS]cat [sep] [MASK]", "$x+y=<z>^`|~ ¿qué? «hi» e.g. don't",
    "unknownword the zzzq", "dogs dog cats",
]


def _texts(vocab, seed, n=60):
    rng = np.random.default_rng(seed)
    words = [w for w in vocab if not w.startswith("[")] + ["Zq", "UNKNOWNWORD", "e.g.", "don't", "日本"]
    return TEXTS + [" ".join(rng.choice(words, rng.integers(0, 30))) for _ in range(n)]


@pytest.fixture(scope="module", params=["tests_vocab", "seeded_vocab", "cased"])
def pair(request, tmp_path_factory):
    """(BertTokenizerFast, the port's tokenizer, texts) over one checkpoint
    directory: the model tests' vocabulary, a larger seeded one, and the
    seeded one cased (``do_lower_case=False``, accents kept)."""
    d = tmp_path_factory.mktemp(request.param)
    vocab = VOCAB if request.param == "tests_vocab" else seeded_vocab(0)
    kw = {"do_lower_case": False} if request.param == "cased" else {}
    with open(d / "vocab.txt", "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    transformers.BertTokenizerFast(vocab_file=str(d / "vocab.txt"), **kw).save_pretrained(str(d))
    return transformers.AutoTokenizer.from_pretrained(str(d)), WordPieceTokenizer.from_dir(str(d)), _texts(vocab, 1)


def test_single_texts_equal_ids(pair):
    ref, port, texts = pair
    for text in texts:
        assert port.encode([text])[0] == ref(text)["input_ids"], repr(text)


@pytest.mark.parametrize("max_length", [5, 8, 9, 16, 33])
@pytest.mark.parametrize("padding", [True, "max_length"])
def test_batches_truncated_and_padded(pair, max_length, padding):
    """Singles and pairs, truncated (``longest_first`` for pairs) and padded
    to the longest or to ``max_length``: every array equal, int64."""
    ref, port, texts = pair
    first, second = texts[:38], texts[38:76]
    for args in ((first,), (first, second)):
        want = ref(*args, padding=padding, truncation=True, max_length=max_length, return_tensors="np")
        got = port(*args, padding=padding, max_length=max_length)
        for key in ("input_ids", "token_type_ids", "attention_mask"):
            assert got[key].dtype == np.int64 and np.array_equal(got[key], want[key]), (len(args), key)


def test_normalizer_equal_over_stable_blocks(pair):
    """The normalizer, char by char, over Latin, Greek, Cyrillic, general
    punctuation and CJK punctuation (blocks whose categories have not moved
    between Unicode versions)."""
    ref, port, _ = pair
    norm = ref.backend_tokenizer.normalizer
    for lo, hi in ((0, 0x600), (0x2000, 0x2070), (0x3000, 0x3040), (0x4E00, 0x4E20), (0xFF00, 0xFF20)):
        for cp in range(lo, hi):
            s = f"Ab{chr(cp)}c"
            assert port._normalize(s) == norm.normalize_str(s), hex(cp)


def test_memo_keeps_ids(pair):
    """A word met again comes from the memo with the same ids."""
    ref, port, texts = pair
    port._memo.clear()
    first = [port.tokenize(t) for t in texts]
    assert port._memo
    assert [port.tokenize(t) for t in texts] == first


def test_too_short_max_length_raises(pair):
    _, port, _ = pair
    with pytest.raises(ValueError):
        port(["a"], ["b"], max_length=2)
