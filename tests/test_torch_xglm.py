"""XGLM in the port (``xglm.py``), which the reference runs as an RM only,
against the JAX package's classes on tiny checkpoints (width 32, 2 layers,
4 heads, FFN 64, 128 positions, weights of std 0.2) saved with
``save_pretrained``, their tokenizers ``XGLMConverter``'s Unigram with the
``</s> $A`` template, padded on the right:

- ``TorchSentenceEncoderRM(device="cpu")`` equals ``JaxSentenceEncoderRM``
  within 1e-5 in f32 for mean and CLS pooling, normalised and not, over a
  padded last batch and two sequence buckets; with ``scale_embedding`` on
  and off; from ``flax_model.msgpack``, from ``.bin`` and safetensors
  shards and from an ``XGLMForCausalLM`` file (``model.`` names);
- the positions are ``arange + 2`` whatever the padding: a right-padded
  text embeds as it does alone, and the table is Flax's, whatever
  position weights the file carries;
- in bf16 the residual stream is f32, as the reference's (its f32
  positions promote it): every layer's output is f32, the last hidden
  state bf16, and the embeddings equal the reference's bf16 run within
  5e-3;
- a bucket past ``max_position_embeddings`` raises ``ValueError`` in both
  packages; no pad token raises ``ValueError`` in both; a reranker is
  refused as the Flax auto class refuses it;
- the tokenizer id for id against ``AutoTokenizer``
  (``XGLMTokenizerFast``: ``</s>`` before the text, the seven
  ``<madeupwordN>`` pieces split out as special tokens).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402
from torch_families import XGLM_MADEUP, seeded_texts, seeded_words, write_alibi_decoder  # noqa: E402

from lotus_tpu.models import JaxSentenceEncoderRM  # noqa: E402
from lotus_tpu_torch.models import (  # noqa: E402
    TorchCrossEncoderReranker, TorchSentenceEncoderRM, XGLMConfig, load_encoder, load_state_dict, load_tokenizer,
)
from lotus_tpu_torch.models.torch_rm import bucketed_batches  # noqa: E402
from lotus_tpu_torch.models.xglm import sinusoidal_positions  # noqa: E402

DOCS = seeded_texts(5, 6, seeded_words(0, 200), 1, 6) + ["", " ".join(seeded_words(1, 14)),
                                                           "Hello, WORLD! naïve ① 日本 😀 <madeupword3>"]
LONG = " ".join(seeded_words(2, 200))  # past 128 tokens


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("xglm"))
    write_alibi_decoder(d, "xglm", seed=3, init_range=0.2)
    return d


def assert_equal_jax(d: str, docs=DOCS, **kw) -> np.ndarray:
    """The port's embeddings of ``docs`` equal the reference's within 1e-5."""
    kw = {"max_batch_size": 4, **kw}
    want = JaxSentenceEncoderRM(model=d, **kw)._embed(docs)
    got = TorchSentenceEncoderRM(model=d, device="cpu", **kw)._embed(docs)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    return got


@pytest.mark.parametrize("pooling,normalize", [("mean", True), ("mean", False), ("cls", True), ("cls", False)])
def test_embeddings_equal_jax(checkpoint, pooling, normalize):
    got = assert_equal_jax(checkpoint, pooling=pooling, normalize_embeddings=normalize)
    port = TorchSentenceEncoderRM(model=checkpoint, device="cpu", max_batch_size=4)
    buckets = {ids.shape[1] for _, ids, _ in bucketed_batches(port.tokenizer, DOCS, None, 4, 512, "cpu")}
    assert len(buckets) >= 2 and got.shape == (len(DOCS), 32)


@pytest.mark.parametrize("scale", [True, False])
def test_scale_embedding(tmp_path, scale):
    """``scale_embedding`` multiplies the token embeddings by sqrt(d_model)
    before the positions are added: each setting equals the reference."""
    d = str(tmp_path / "xglm")
    write_alibi_decoder(d, "xglm", seed=4, init_range=0.2, scale_embedding=scale)
    assert load_encoder(d).config.scale_embedding is scale
    got = assert_equal_jax(d)
    other = str(tmp_path / "other")
    write_alibi_decoder(other, "xglm", seed=4, init_range=0.2, scale_embedding=not scale)
    assert np.abs(got - TorchSentenceEncoderRM(model=other, device="cpu", max_batch_size=4)._embed(DOCS)).max() > 1e-3


def test_right_padding_offset_positions(checkpoint):
    """The tokenizer pads on the right and puts ``</s>`` first; positions are
    ``arange + 2`` whatever the padding, so a padded text embeds as it does
    alone.  The table's rows are Flax's ``create_sinusoidal_positions``."""
    from transformers.models.xglm.modeling_flax_xglm import create_sinusoidal_positions

    ref = transformers.AutoTokenizer.from_pretrained(checkpoint)
    port = load_tokenizer(checkpoint)
    assert ref.padding_side == port.padding_side == "right"
    batch = DOCS[:4]
    (_, ids, mask), = bucketed_batches(port, batch, None, 4, 512, "cpu")
    want = ref(batch, padding="max_length", truncation=True, max_length=ids.shape[1], return_tensors="np")
    np.testing.assert_array_equal(ids.numpy(), want["input_ids"])
    np.testing.assert_array_equal(mask.numpy(), want["attention_mask"])
    assert (ids[:, 0] == ref.eos_token_id).all() and (mask[:, -1] == 0).any()
    rm = TorchSentenceEncoderRM(model=checkpoint, device="cpu", max_batch_size=4)
    np.testing.assert_allclose(rm._embed(batch), np.concatenate([rm._embed([t]) for t in batch]), atol=1e-6, rtol=0)
    table = np.asarray(create_sinusoidal_positions(130, 32))
    np.testing.assert_array_equal(sinusoidal_positions(128, 32).numpy(), table[2:])


def test_stored_positions_are_not_read(checkpoint, tmp_path):
    """A file that carries ``embed_positions.weights`` (older torch files
    do) embeds as the one without: the table is computed."""
    from safetensors.torch import save_file

    from lotus_tpu_torch.models.checkpoint import read_safetensors

    d = str(tmp_path / "stored")
    shutil.copytree(checkpoint, d)
    state = read_safetensors(os.path.join(d, "model.safetensors"))
    state["embed_positions.weights"] = torch.randn(130, 32)
    save_file(state, os.path.join(d, "model.safetensors"), metadata={"format": "pt"})
    got = TorchSentenceEncoderRM(model=d, device="cpu", max_batch_size=4)._embed(DOCS)
    want = TorchSentenceEncoderRM(model=checkpoint, device="cpu", max_batch_size=4)._embed(DOCS)
    np.testing.assert_array_equal(got, want)


def test_bf16_residual_stream(checkpoint):
    """Flax adds f32 positions to the bf16 embeddings, so every layer's
    output is f32; the final LayerNorm gives bf16.  The port's bf16 forward
    keeps the same dtypes and equals the reference's bf16 run within 5e-3."""
    enc = load_encoder(checkpoint, dtype=torch.bfloat16)
    seen = []
    hooks = [layer.register_forward_hook(lambda m, a, out: seen.append(out.dtype)) for layer in enc.layers]
    ids = torch.tensor(load_tokenizer(checkpoint).encode(DOCS[:1]))
    with torch.no_grad():
        last = enc(ids, torch.ones_like(ids))
    for h in hooks:
        h.remove()
    assert seen == [torch.float32] * 2 and last.dtype == torch.bfloat16
    want = JaxSentenceEncoderRM(model=checkpoint, max_batch_size=4, dtype=jnp.bfloat16)._embed(DOCS)
    got = TorchSentenceEncoderRM(model=checkpoint, device="cpu", max_batch_size=4, dtype=torch.bfloat16)._embed(DOCS)
    assert got.dtype == np.float32 and float(np.abs(got - want).max()) <= 5e-3


def test_flax_msgpack_equals_jax(checkpoint, tmp_path):
    flax_dir = str(tmp_path / "flax")
    transformers.FlaxAutoModel.from_pretrained(checkpoint, from_pt=True).save_pretrained(flax_dir)
    for name in os.listdir(checkpoint):
        if not name.startswith(("model.", "config")):
            shutil.copy(os.path.join(checkpoint, name), flax_dir)
    got = assert_equal_jax(flax_dir)
    torch_file = TorchSentenceEncoderRM(model=checkpoint, device="cpu", max_batch_size=4)._embed(DOCS)
    np.testing.assert_allclose(got, torch_file, atol=1e-6, rtol=0)


@pytest.mark.parametrize("layout", ["bin-shards", "safetensors-shards", "causal-lm"])
def test_checkpoint_layouts(checkpoint, tmp_path, layout):
    """Shards (``.bin``, which the reference reads too, and safetensors,
    which it refuses) and an ``XGLMForCausalLM`` file (``model.`` names
    beside ``lm_head``) load to the base model's parameters."""
    d = str(tmp_path / layout)
    if layout == "causal-lm":
        write_alibi_decoder(d, "xglm", seed=3, init_range=0.2, causal_lm=True)
        assert all(k.startswith(("model.", "lm_head.")) for k in load_state_dict(d))
        assert_equal_jax(d)
        want = {k.removeprefix("model."): t for k, t in load_state_dict(d).items() if k != "lm_head.weight"}
    else:
        shutil.copytree(checkpoint, d, ignore=shutil.ignore_patterns("model.safetensors"))
        transformers.AutoModel.from_pretrained(checkpoint).save_pretrained(
            d, max_shard_size="20KB", safe_serialization=layout == "safetensors-shards")
        assert len([f for f in os.listdir(d) if f.startswith(("model-", "pytorch_model-"))]) > 2
        if layout == "bin-shards":
            assert_equal_jax(d)
        want = load_state_dict(checkpoint)
    got = load_encoder(d).state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_config_aliases():
    """``XGLMConfig``'s attribute map: ``hidden_size``, ``num_attention_heads``
    and ``num_hidden_layers`` name ``d_model``, ``attention_heads`` and
    ``num_layers``."""
    raw = {"model_type": "xglm", "hidden_size": 64, "num_attention_heads": 8, "num_hidden_layers": 3,
           "vocab_size": 100}
    ref = transformers.XGLMConfig(**{k: v for k, v in raw.items() if k != "model_type"})
    cfg = XGLMConfig.from_dict(raw)
    assert (cfg.d_model, cfg.attention_heads, cfg.num_layers) == (ref.d_model, ref.attention_heads,
                                                                  ref.num_layers) == (64, 8, 3)
    assert cfg.hidden_size == 64


def test_tokenizer_ids_match_auto_tokenizer(checkpoint):
    ref = transformers.AutoTokenizer.from_pretrained(checkpoint)
    port = load_tokenizer(checkpoint)
    texts = seeded_texts(7, 40, seeded_words(0, 200), 0, 30) + DOCS + [
        "  leading and trailing  ", "a\tb\nc", "ＡＢ ① ㍿ ﬁne", "<s> inside </s>", " ".join(XGLM_MADEUP)]
    assert port.encode(texts) == ref(texts)["input_ids"]
    assert port.encode(texts, max_length=12) == ref(texts, truncation=True, max_length=12)["input_ids"]
    second = texts[::-1]
    assert port.encode(texts, second, max_length=24) == ref(texts, second, truncation=True, max_length=24)["input_ids"]
    got = port(texts[:8], texts[8:16], max_length=32, padding=True)
    enc = ref(texts[:8], texts[8:16], truncation=True, max_length=32, padding=True)
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[key], enc[key])
    vocab = ref.get_vocab()
    assert port.encode(["hi"])[0][0] == vocab["</s>"] == 2
    assert [vocab[w] for w in XGLM_MADEUP] == list(range(len(vocab) - 7, len(vocab)))
    assert port.encode([" ".join(XGLM_MADEUP)])[0][1:] == [vocab[w] for w in XGLM_MADEUP]


def test_length_error_matches_reference(checkpoint):
    docs = ["short one", LONG]
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        JaxSentenceEncoderRM(model=checkpoint, max_batch_size=2, max_seq_length=256)._embed(docs)
    with pytest.raises(ValueError, match="256-token bucket is longer than max_position_embeddings 128"):
        TorchSentenceEncoderRM(model=checkpoint, max_batch_size=2, max_seq_length=256, device="cpu")._embed(docs)


def test_missing_pad_token_raises(tmp_path):
    d = str(tmp_path / "xglm")
    write_alibi_decoder(d, "xglm", seed=3, tokenizer_kw={"pad": None}, num_layers=1)
    with open(os.path.join(d, "tokenizer_config.json"), encoding="utf-8") as f:
        assert json.load(f).get("pad_token") is None
    with pytest.raises(ValueError, match="padding"):
        JaxSentenceEncoderRM(model=d, max_batch_size=2)._embed(DOCS[:2])
    with pytest.raises(ValueError, match="no padding token"):
        TorchSentenceEncoderRM(model=d, max_batch_size=2, device="cpu")._embed(DOCS[:2])


def test_reranker_refused(checkpoint):
    with pytest.raises(ValueError, match="Unrecognized configuration class"):
        transformers.FlaxAutoModelForSequenceClassification.from_pretrained(checkpoint, from_pt=True)
    with pytest.raises(ValueError, match="model_type 'xglm' has no sequence classifier"):
        TorchCrossEncoderReranker(model=checkpoint, device="cpu")
