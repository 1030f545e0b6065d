"""GPT-SW3 in the port (GPT-2's forward, ``gpt2.py``, behind the slow
``GPTSw3Tokenizer`` over ``spiece.model``, ``gpt_sw3_tokenizer.py``),
which the reference runs as an RM only, against the JAX package's classes
on tiny checkpoints (width 32, 2 layers, 4 heads, FFN 64, 128 positions,
weights of std 0.2) whose ``spiece.model`` is a seeded sentencepiece BPE
with byte fallback and GPT-SW3's ``<unk> <pad> <s> <|endoftext|>`` first.

Neither machine has ``sentencepiece``, so the reference cannot build
``GPTSw3Tokenizer``: it reads a twin directory whose ``tokenizer.json``
is ``SpmConverter``'s conversion of the same ``spiece.model``
(``torch_families.twin``).

- On the same ids (the twin's tokenizer in both packages),
  ``TorchSentenceEncoderRM(device="cpu")`` equals ``JaxSentenceEncoderRM``
  within 1e-5 in f32, mean and CLS pooling, normalised and not, over two
  sequence buckets, for ``model_type`` ``gpt-sw3`` and ``gpt2``; in bf16
  within 1e-2 and a cosine of 0.999 (bf16's rounding), departing from f32
  as far as the reference's bf16 does, within a factor of 2;
- the whole RM from text: the ``spiece.model`` directory in the port
  equals the twin in the reference within 1e-5, over texts where the two
  tokenizers agree (no unknown character, which sentencepiece sends to
  bytes and the conversion to ``<unk>``; single spaces, which
  ``remove_extra_whitespaces`` false keeps and the conversion collapses);
- the tokenizer against ``transformers``' own ``GPTSw3Tokenizer`` class,
  its ``sentencepiece`` stood in for by the port's encoder (held to the
  ``tokenizers`` conversion in ``test_torch_sentencepiece.py``): the
  class's ``preprocess_text``, its defaults (``gpt-sw3-7b`` in the name),
  special tokens split off, ``do_lower_case``, added tokens;
- a pad token ``spiece.model`` lacks (added past the vocabulary): the
  reference's embeddings are not finite, the port raises ``ValueError``;
  a reranker is refused as the Flax auto class refuses it.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402
from torch_families import seeded_words, twin, write_gpt_sw3  # noqa: E402

from lotus_tpu.models import JaxSentenceEncoderRM  # noqa: E402
from lotus_tpu_torch.models import (  # noqa: E402
    GPTSw3Tokenizer, SentencePieceEncoder, TorchCrossEncoderReranker, TorchSentenceEncoderRM, load_encoder,
    load_tokenizer,
)
from lotus_tpu_torch.models.gpt_sw3_tokenizer import preprocess_text  # noqa: E402
from lotus_tpu_torch.models.torch_rm import bucketed_batches  # noqa: E402


def plain_texts(seed: int, n: int, lo: int, hi: int) -> list[str]:
    """Texts of the seeded model's own words and known punctuation, one
    space apart."""
    rng = np.random.default_rng(seed)
    words = seeded_words(3, 200) + ["Hello,", "WORLD!", "it's", "12", "3.5"]
    return [" ".join(rng.choice(words, int(rng.integers(lo, hi + 1)))) for _ in range(n)]


DOCS = plain_texts(5, 7, 1, 12) + ["", plain_texts(6, 1, 60, 60)[0]]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("gpt-sw3")
    d = write_gpt_sw3(str(root / "gpt-sw3"), seed=3)
    return d, twin(d, str(root / "twin"))


def assert_equal_jax(port_dir: str, ref_dir: str, docs=DOCS, **kw) -> np.ndarray:
    kw = {"max_batch_size": 4, **kw}
    want = JaxSentenceEncoderRM(model=ref_dir, **kw)._embed(docs)
    got = TorchSentenceEncoderRM(model=port_dir, device="cpu", **kw)._embed(docs)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    return got


@pytest.mark.parametrize("pooling,normalize", [("mean", True), ("mean", False), ("cls", True), ("cls", False)])
def test_embeddings_equal_jax_on_the_same_ids(dirs, pooling, normalize):
    _, ref = dirs
    got = assert_equal_jax(ref, ref, pooling=pooling, normalize_embeddings=normalize)
    port = TorchSentenceEncoderRM(model=ref, device="cpu", max_batch_size=4)
    assert len({ids.shape[1] for _, ids, _ in bucketed_batches(port.tokenizer, DOCS, None, 4, 512, "cpu")}) >= 2
    assert got.shape == (len(DOCS), 32)


def test_whole_rm_from_text(dirs):
    """``spiece.model`` read by the port against the twin's converted
    tokenizer in the reference: the same ids, the same embeddings."""
    d, ref = dirs
    port = load_tokenizer(d)
    assert isinstance(port, GPTSw3Tokenizer) and port.padding_side == "right"
    fast = transformers.AutoTokenizer.from_pretrained(ref)
    assert port.encode(DOCS) == fast(DOCS)["input_ids"]
    assert port.pad_id == fast.pad_token_id == 1
    assert_equal_jax(d, ref)


@pytest.mark.parametrize("model_type", ["gpt2", "gpt-sw3"])
def test_model_types(tmp_path, model_type):
    """The published files say ``gpt2``; ``gpt-sw3`` is the type that
    AutoConfig maps to ``GPT2Config``: both load as GPT-2."""
    d = write_gpt_sw3(str(tmp_path / model_type), seed=4, model_type=model_type)
    with open(os.path.join(d, "config.json"), encoding="utf-8") as f:
        assert json.load(f)["model_type"] == model_type
    assert type(load_encoder(d)).__name__ == "GPT2Model"
    assert_equal_jax(d, twin(d, str(tmp_path / "twin")), docs=DOCS[:4])


def test_bf16_close_to_reference(dirs):
    """In bf16 both packages round every product to 8 bits of mantissa, at
    different points (XLA keeps f32 through its fusions): the embeddings
    agree within 1e-2 and at a cosine of at least 0.999 a row.  That limit
    alone would pass an f32 forward (the reference's bf16 is as far from
    its f32), so the port's bf16 must also depart from its own f32 by 0.5
    to 2 times what the reference's departs from f32 (``bf16_readings.py``:
    0.62 to 1.66 over 12 seeded cases, here 0.62 for GPT-SW3 and 0.93 for
    Marian; an f32 forward rounded once at the end departs 0.09 to 0.59
    times, here 0.13 and 0.09)."""
    d, ref = dirs
    want = JaxSentenceEncoderRM(model=ref, max_batch_size=4, dtype=jnp.bfloat16)._embed(DOCS)
    got = TorchSentenceEncoderRM(model=d, device="cpu", max_batch_size=4, dtype=torch.bfloat16)._embed(DOCS)
    assert got.dtype == np.float32 and float(np.abs(got - want).max()) <= 1e-2
    rows = np.linalg.norm(want, axis=1) > 0  # the empty text pools to zeros
    assert float(np.sum(got * want, axis=1)[rows].min()) >= 0.999
    ref_f32 = JaxSentenceEncoderRM(model=ref, max_batch_size=4)._embed(DOCS)
    port_f32 = TorchSentenceEncoderRM(model=d, device="cpu", max_batch_size=4)._embed(DOCS)
    ratio = float(np.abs(got - port_f32).max()) / float(np.abs(want - ref_f32).max())
    assert 0.5 <= ratio <= 2.0, ratio


# ---- the tokenizer against transformers' own class ---------------------------------

@pytest.fixture
def slow_class(monkeypatch):
    """``transformers``' ``GPTSw3Tokenizer`` with a ``sentencepiece`` module
    whose processor is the port's encoder (``Load``, ``encode``,
    ``PieceToId``, ``IdToPiece``, ``__len__``)."""
    class Processor:
        def __init__(self, **kw):
            self.kw = kw

        def Load(self, path):  # noqa: N802 (sentencepiece's name)
            self.enc = SentencePieceEncoder.from_file(path)

        def encode(self, text, out_type=int):
            assert out_type is str
            return self.enc.encode(text)

        def PieceToId(self, piece):  # noqa: N802
            return self.enc.piece_to_id(piece)

        def IdToPiece(self, i):  # noqa: N802
            return self.enc.proto.pieces[i].piece

        def __len__(self):
            return len(self.enc)

    stand_in = types.ModuleType("sentencepiece")
    stand_in.SentencePieceProcessor = Processor
    monkeypatch.setitem(sys.modules, "sentencepiece", stand_in)
    monkeypatch.delitem(sys.modules, "transformers.models.gpt_sw3.tokenization_gpt_sw3", raising=False)
    from transformers.models.gpt_sw3.tokenization_gpt_sw3 import GPTSw3Tokenizer as Slow

    return Slow


TEXTS = DOCS + [
    "Svenska \u00e4r kul!", "  two  spaces ", "tabs\tand\nnew lines", "non\u00a0breaking thin\u2009wide\u3000end",
    "zero\u200bwidth soft\u00adhyphen \x07bell\x9fend\x84", "e\u0301 composed by NFC", "emoji \U0001F600 \u65e5\u672c",
    "<|endoftext|>between<s>specials<pad> <unk>", "MiXeD CaSe <s> \u00c5\u00c4\u00d6"]


@pytest.mark.parametrize("config", [{}, {"do_lower_case": True}, {"pad_token": "<unk>", "bos_token": "<s>"}])
def test_tokenizer_equals_the_slow_class(dirs, slow_class, config):
    d, _ = dirs
    cfg_path = os.path.join(d, "tokenizer_config.json")
    with open(cfg_path, encoding="utf-8") as f:
        saved = json.load(f)
    with open(cfg_path, "w", encoding="utf-8") as f:
        json.dump({**saved, **config}, f)
    try:
        ref = slow_class.from_pretrained(d)
        port = load_tokenizer(d)
    finally:
        with open(cfg_path, "w", encoding="utf-8") as f:
            json.dump(saved, f)
    assert [ref(t)["input_ids"] for t in TEXTS] == port.encode(TEXTS)
    assert port.encode(TEXTS, max_length=8) == ref(TEXTS, truncation=True, max_length=8)["input_ids"]
    enc = ref(TEXTS[:6], padding=True, truncation=True, max_length=24)
    got = port(TEXTS[:6], max_length=24, padding=True)
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[key], enc[key])
    assert port.pad_id == ref.pad_token_id and ref.padding_side == port.padding_side
    for text in TEXTS:
        assert preprocess_text(text) == ref.preprocess_text(text)


def test_seven_b_defaults(tmp_path, slow_class):
    """Where the directory's name holds ``gpt-sw3-7b`` the pad token
    defaults to the unknown token and bos to eos, as ``__init__`` sets them;
    a special token the model lacks is added past its pieces."""
    d = write_gpt_sw3(str(tmp_path / "gpt-sw3-7b"), seed=5, n_layer=1)
    cfg = os.path.join(d, "tokenizer_config.json")
    with open(cfg, encoding="utf-8") as f:
        saved = json.load(f)
    with open(cfg, "w", encoding="utf-8") as f:
        json.dump({**saved, "eos_token": "<eos-new>"}, f)
    ref, port = slow_class.from_pretrained(d), load_tokenizer(d)
    assert ref.pad_token == "<unk>" and ref.bos_token == "<eos-new>"
    assert port.pad_id == ref.pad_token_id == 0
    assert ref.convert_tokens_to_ids("<eos-new>") == len(port.sp) == port.vocab["<eos-new>"]
    assert port.encode(TEXTS) == [ref(t)["input_ids"] for t in TEXTS]


def test_pad_token_outside_the_vocabulary(tmp_path):
    """A pad token ``spiece.model`` lacks is added past its pieces, so the
    padded rows carry an id the model has no row for: the reference's Flax
    embedding gathers NaN there, the port raises ``ValueError``."""
    d = write_gpt_sw3(str(tmp_path / "gpt-sw3"), seed=6, n_layer=1, tokenizer_config={"pad_token": "<pad-new>"})
    ref = twin(d, str(tmp_path / "twin"))
    cfg = os.path.join(ref, "tokenizer_config.json")
    with open(cfg, encoding="utf-8") as f:
        saved = json.load(f)
    with open(cfg, "w", encoding="utf-8") as f:
        json.dump({**saved, "pad_token": "<pad-new>"}, f)
    want = JaxSentenceEncoderRM(model=ref, max_batch_size=4)._embed(DOCS[:2])
    assert not np.isfinite(want).all()
    port = TorchSentenceEncoderRM(model=d, device="cpu", max_batch_size=4)
    assert port.tokenizer.pad_id == len(port.tokenizer.sp)
    with pytest.raises(ValueError, match="outside the model's"):
        port._embed(DOCS[:2])


def test_reranker_refused(dirs):
    d, _ = dirs
    with pytest.raises(ValueError, match="Unrecognized configuration class"):
        transformers.FlaxAutoModelForSequenceClassification.from_pretrained(d, from_pt=True)
    with pytest.raises(ValueError, match="model_type 'gpt2' has no sequence classifier"):  # gpt-sw3's config class
        TorchCrossEncoderReranker(model=d, device="cpu")
