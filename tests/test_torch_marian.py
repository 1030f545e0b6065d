"""Marian in the port (``marian.py``: BART's skeleton, post-LN, sinusoidal
positions from row 0, one ``shared`` embedding; ``marian_tokenizer.py``:
the slow ``MarianTokenizer``'s source side over ``source.spm`` and
``vocab.json``), which the reference runs as an RM only, against the JAX
package's classes on tiny checkpoints in opus-mt's layout (width 32, 2 + 2
layers, 2 heads, FFN 64, 128 positions, ``swish``, ``scale_embedding``,
pad and decoder start the last id, eos 0, weights of std 0.2) whose
``source.spm`` is a seeded Unigram behind a charsmap.

Neither machine has ``sentencepiece``, so the reference cannot build
``MarianTokenizer``: it reads a twin directory whose ``tokenizer.json`` is
``SpmConverter``'s conversion of ``source.spm`` with ``vocab.json``'s ids
and the ``$A </s>`` template (``torch_families.twin``).

- On the same ids, ``TorchSentenceEncoderRM(device="cpu")`` equals
  ``JaxSentenceEncoderRM`` within 1e-5 in f32, mean and CLS pooling,
  normalised and not, over two sequence buckets; in bf16 within 1e-2,
  departing from f32 as far as the reference's bf16 does, within a factor
  of 2;
- the whole RM from text (``source.spm`` + ``vocab.json`` in the port, the
  twin in the reference) within 1e-5 over texts where the tokenizers agree;
- the tokenizer against ``transformers``' own ``MarianTokenizer`` class,
  its ``sentencepiece`` stood in for by the port's encoder: ids from
  ``vocab.json``, ``>>xx<<`` split off, ``</s>`` appended, no punctuation
  normalization, and ``KeyError`` without ``<unk>``;
- the positions are Flax's ``create_sinusoidal_positions`` from row 0,
  held against a torch file's ``embed_positions.weight``; a separate
  ``decoder.embed_tokens.weight`` that differs from ``shared`` raises;
  ``from_flax_params`` carries Flax Marian's tree;
- where the reference fails: a decoder start id outside the vocabulary
  (the reference's embeddings are not finite, the port raises
  ``ValueError``), a bucket past ``max_position_embeddings`` (both
  raise); a reranker is refused as the Flax auto class refuses it.
"""

import json
import os
import shutil
import sys
import types

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402
from torch_families import seeded_words, twin, write_marian  # noqa: E402

from lotus_tpu.models import JaxSentenceEncoderRM  # noqa: E402
from lotus_tpu_torch.models import (  # noqa: E402
    MarianConfig, MarianTokenizer, SentencePieceEncoder, TorchCrossEncoderReranker, TorchSentenceEncoderRM,
    from_flax_params, load_encoder, load_state_dict, load_tokenizer,
)
from lotus_tpu_torch.models.checkpoint import read_safetensors  # noqa: E402
from lotus_tpu_torch.models.roformer import sinusoidal_positions  # noqa: E402
from lotus_tpu_torch.models.torch_rm import bucketed_batches  # noqa: E402


def plain_texts(seed: int, n: int, lo: int, hi: int) -> list[str]:
    """Texts of the seeded model's own words, known punctuation and the
    charsmap's keys, one space apart."""
    rng = np.random.default_rng(seed)
    words = seeded_words(3, 200) + ["Hello,", "WORLD!", "it's", "12", "Ａb", "①"]
    return [" ".join(rng.choice(words, int(rng.integers(lo, hi + 1)))) for _ in range(n)]


DOCS = plain_texts(5, 7, 1, 12) + ["", plain_texts(6, 1, 60, 60)[0]]
LONG = plain_texts(7, 1, 200, 200)[0]  # past 128 tokens


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("marian")
    d = write_marian(str(root / "marian"), seed=3)
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
    cfg = port.encoder.config
    assert (cfg.activation_function, cfg.scale_embedding) == ("swish", True)
    assert cfg.decoder_start_token_id == cfg.pad_token_id == cfg.vocab_size - 1  # <pad>, vocab.json's last


def test_whole_rm_from_text(dirs):
    """``source.spm`` and ``vocab.json`` read by the port against the twin's
    converted tokenizer in the reference: the same ids, the same
    embeddings."""
    d, ref = dirs
    port = load_tokenizer(d)
    assert isinstance(port, MarianTokenizer) and port.padding_side == "right"
    fast = transformers.AutoTokenizer.from_pretrained(ref)
    assert port.encode(DOCS) == fast(DOCS)["input_ids"]
    assert port.encode(DOCS[:3], max_length=5) == fast(DOCS[:3], truncation=True, max_length=5)["input_ids"]
    assert port.pad_id == fast.pad_token_id == len(port.encoder) - 1
    assert_equal_jax(d, ref)


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
    assert float(np.sum(got * want, axis=1).min()) >= 0.999
    ref_f32 = JaxSentenceEncoderRM(model=ref, max_batch_size=4)._embed(DOCS)
    port_f32 = TorchSentenceEncoderRM(model=d, device="cpu", max_batch_size=4)._embed(DOCS)
    ratio = float(np.abs(got - port_f32).max()) / float(np.abs(want - ref_f32).max())
    assert 0.5 <= ratio <= 2.0, ratio


# ---- the tokenizer against transformers' own class ---------------------------------

@pytest.fixture
def slow_class(monkeypatch):
    """``transformers``' ``MarianTokenizer`` with a ``sentencepiece`` module
    whose processor is the port's encoder."""
    class Processor:
        def __init__(self, **kw):
            self.kw = kw

        def Load(self, path):  # noqa: N802 (sentencepiece's name)
            self.enc = SentencePieceEncoder.from_file(path)

        def encode(self, text, out_type=int):
            assert out_type is str
            return self.enc.encode(text)

    stand_in = types.ModuleType("sentencepiece")
    stand_in.SentencePieceProcessor = Processor
    monkeypatch.setitem(sys.modules, "sentencepiece", stand_in)
    monkeypatch.delitem(sys.modules, "transformers.models.marian.tokenization_marian", raising=False)
    from transformers.models.marian.tokenization_marian import MarianTokenizer as Slow

    return Slow


TEXTS = DOCS + [
    ">>de<< Hello, WORLD!", ">>fr<<no space", "a >>de<< inside", ">>unfinished", "  two  spaces ",
    "“quotes” – dashes … and « guillemets »", "emoji \U0001F600 日本",
    "</s> and <unk> and <pad> typed", "ＡＢ ① 　wide", "tab\there"]


def test_tokenizer_equals_the_slow_class(dirs, slow_class):
    """Ids from ``vocab.json`` (an unknown piece is ``<unk>``), a leading
    ``>>xx<<`` split off as one token, ``</s>`` after each text, the special
    tokens split out of the text, and no Moses punctuation normalization
    (``__call__`` never calls ``normalize``)."""
    d, _ = dirs
    ref = slow_class.from_pretrained(d)
    port = load_tokenizer(d)
    assert [ref(t)["input_ids"] for t in TEXTS] == port.encode(TEXTS)
    assert port.encode(TEXTS, max_length=6) == ref(TEXTS, truncation=True, max_length=6)["input_ids"]
    enc = ref(TEXTS[:6], padding=True, truncation=True, max_length=24)
    got = port(TEXTS[:6], max_length=24, padding=True)
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[key], enc[key])
    assert ">>de<<" not in port.vocab and port.encode([">>de<< x"])[0][0] == port.unk_id == 1


def test_language_code_and_missing_unknown(tmp_path, slow_class):
    """A ``>>de<<`` that ``vocab.json`` holds gets its own id; a
    ``vocab.json`` without ``<unk>`` raises ``KeyError`` in both."""
    d = write_marian(str(tmp_path / "marian"), seed=4, encoder_layers=1, decoder_layers=1)
    path = os.path.join(d, "vocab.json")
    with open(path, encoding="utf-8") as f:
        vocab = json.load(f)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({**vocab, ">>de<<": len(vocab)}, f)
    ref, port = slow_class.from_pretrained(d), load_tokenizer(d)
    assert port.encode([">>de<< Hello"]) == [ref(">>de<< Hello")["input_ids"]]
    assert port.encode([">>de<< Hello"])[0][0] == len(vocab)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({k: v for k, v in vocab.items() if k != "<unk>"}, f)
    with pytest.raises(KeyError, match="<unk>"):
        slow_class.from_pretrained(d)
    with pytest.raises(KeyError, match="<unk>"):
        load_tokenizer(d)


# ---- the model ---------------------------------------------------------------------

def test_positions_and_stored_tables(dirs, tmp_path):
    """The table is Flax's ``create_sinusoidal_positions`` from row 0; the
    torch file's ``embed_positions.weight`` (which ``save_pretrained``
    writes) is held to it and never loaded: a file whose table differs is
    refused."""
    from safetensors.torch import save_file
    from transformers.models.marian.modeling_flax_marian import create_sinusoidal_positions

    d, _ = dirs
    np.testing.assert_allclose(sinusoidal_positions(128, 32).numpy(), np.asarray(create_sinusoidal_positions(128, 32)),
                               atol=1e-6, rtol=0)
    state = read_safetensors(os.path.join(d, "model.safetensors"))
    assert "encoder.embed_positions.weight" in state or "model.encoder.embed_positions.weight" in state
    bad = str(tmp_path / "bad")
    shutil.copytree(d, bad)
    key = next(k for k in state if k.endswith("decoder.embed_positions.weight"))
    state[key] = torch.randn_like(state[key])
    save_file(state, os.path.join(bad, "model.safetensors"), metadata={"format": "pt"})
    with pytest.raises(ValueError, match="not the sinusoid table"):
        load_encoder(bad)


def test_untied_decoder_embeddings_raise(dirs, tmp_path):
    """The reference builds one ``shared`` embedding for both stacks: a file
    whose ``decoder.embed_tokens.weight`` differs from ``shared`` cannot be
    tied so; equal copies load."""
    from safetensors.torch import save_file

    d, _ = dirs
    state = read_safetensors(os.path.join(d, "model.safetensors"))
    shared = next(k for k in state if k.endswith("shared.weight"))
    prefix = shared[: -len("shared.weight")]
    for name, table in (("tied", state[shared].clone()), ("untied", torch.randn_like(state[shared]))):
        out = str(tmp_path / name)
        shutil.copytree(d, out)
        save_file({**state, prefix + "decoder.embed_tokens.weight": table}, os.path.join(out, "model.safetensors"),
                  metadata={"format": "pt"})
        if name == "tied":
            assert torch.equal(load_encoder(out).shared.weight, state[shared])
        else:
            with pytest.raises(ValueError, match="decoder.embed_tokens.weight differs"):
                load_encoder(out)


def test_from_flax_params(dirs):
    """Flax Marian's parameter tree maps onto the port's module by name and
    runs to the reference's embeddings."""
    d, ref = dirs
    flax = transformers.FlaxAutoModel.from_pretrained(d, from_pt=True)
    cfg = MarianConfig.from_dir(d)
    state = from_flax_params(flax.params, cfg)
    want = load_state_dict(d)
    for name, t in state.items():
        src = want.get(name, want.get("model." + name))
        assert src is not None and torch.allclose(t, src.float(), atol=1e-7), name


def test_marian_nan_decoder_start(tmp_path):
    """``decoder_start_token_id`` outside the vocabulary (58,100 over a tiny
    vocabulary, as a config kept from opus-mt with a smaller one has it):
    Flax gathers NaN rows for it, so the reference's embeddings are not
    finite; the port raises ``ValueError``."""
    d = write_marian(str(tmp_path / "marian"), seed=5, encoder_layers=1, decoder_layers=1,
                     decoder_start_token_id=58_100)
    ref = twin(d, str(tmp_path / "twin"))
    want = JaxSentenceEncoderRM(model=ref, max_batch_size=4)._embed(DOCS[:2])
    assert not np.isfinite(want).any()
    with pytest.raises(ValueError, match="decoder_start_token_id 58100 lies outside"):
        TorchSentenceEncoderRM(model=d, device="cpu", max_batch_size=4)


def test_length_error_matches_reference(dirs):
    d, ref = dirs
    docs = ["short one", LONG]
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        JaxSentenceEncoderRM(model=ref, max_batch_size=2, max_seq_length=256)._embed(docs)
    with pytest.raises(ValueError, match="256-token bucket is longer than max_position_embeddings 128"):
        TorchSentenceEncoderRM(model=d, max_batch_size=2, max_seq_length=256, device="cpu")._embed(docs)


def test_reranker_refused(dirs):
    d, _ = dirs
    with pytest.raises(ValueError, match="Unrecognized configuration class"):
        transformers.FlaxAutoModelForSequenceClassification.from_pretrained(d, from_pt=True)
    with pytest.raises(ValueError, match="model_type 'marian' has no sequence classifier"):
        TorchCrossEncoderReranker(model=d, device="cpu")
