"""Llama, Mistral and Gemma in the port (``llama.py``, ``mistral.py``,
``gemma.py``), which the reference runs as RMs only, against the JAX
package's classes on tiny checkpoints (width 32, 2 layers, 4 heads over 2
KV heads, Gemma's one KV head of ``head_dim`` 16, 128 positions, weights
of std 0.2) saved with ``save_pretrained``, their tokenizers left-padded
as ``LlamaTokenizerFast`` and ``GemmaTokenizerFast`` pad:

- ``TorchSentenceEncoderRM(device="cpu")`` equals ``JaxSentenceEncoderRM``
  within 1e-5 for mean and CLS pooling (a left-padded row's CLS is a pad
  position's state), normalised and not, over a padded last batch and two
  sequence buckets, from the torch file and from ``flax_model.msgpack``;
- the reference's quirks, each against it: Mistral's ``sliding_window``
  null (each token sees only itself: a change to token 1 moves no later
  state), 4096 (causal at these lengths) and 3; ``rope_theta`` 500000
  (ignored: equal to 10000); left padding with ``arange`` positions, the
  ids and masks the reference's tokenizer gives; Gemma's unset
  ``hidden_activation`` (the tanh GELU, whatever ``hidden_act`` says);
- sharded checkpoints (``model.safetensors.index.json``,
  ``pytorch_model.bin.index.json``) load to the unsharded parameters, and
  the reference reads the ``.bin`` shards to the same embeddings;
- ``load_encoder(dtype=torch.bfloat16)`` gives the file's weights cast to
  bf16, every parameter in bf16;
- no pad token (Llama-2's and Mistral's tokenizers as published) raises
  ``ValueError`` in both packages; a bucket past
  ``max_position_embeddings`` raises ``ValueError`` in both; a reranker is
  refused as the Flax auto class refuses it.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from torch_families import DECODERS, seeded_texts, seeded_words, write_decoder  # noqa: E402

from lotus_tpu.models import JaxSentenceEncoderRM  # noqa: E402
from lotus_tpu_torch.models import (  # noqa: E402
    TorchCrossEncoderReranker, TorchSentenceEncoderRM, load_encoder, load_state_dict, load_tokenizer,
)
from lotus_tpu_torch.models.checkpoint import read_config  # noqa: E402
from lotus_tpu_torch.models.torch_rm import bucketed_batches  # noqa: E402

FAMILIES = DECODERS[3:]  # llama, mistral, gemma
DOCS = seeded_texts(5, 6, seeded_words(0, 200), 1, 6) + ["", " ".join(seeded_words(1, 14)),
                                                           "Hello, WORLD! naïve ① 日本 😀"]
LONG = " ".join(seeded_words(2, 200))  # past 128 tokens


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    out = {}
    for family in FAMILIES:
        d = str(tmp_path_factory.mktemp(family))
        write_decoder(d, family, seed=3, init_range=0.2)
        out[family] = d
    return out


def assert_equal_jax(d: str, docs=DOCS, **kw) -> np.ndarray:
    """The port's embeddings of ``docs`` equal the reference's within 1e-5."""
    kw = {"max_batch_size": 4, **kw}
    want = JaxSentenceEncoderRM(model=d, **kw)._embed(docs)
    got = TorchSentenceEncoderRM(model=d, device="cpu", **kw)._embed(docs)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    return got


def rewrite_config(d: str, **fields) -> None:
    path = os.path.join(d, "config.json")
    with open(path, encoding="utf-8") as f:
        cfg = json.load(f)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({**cfg, **fields}, f)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("pooling,normalize", [("mean", True), ("mean", False), ("cls", True), ("cls", False)])
def test_embeddings_equal_jax(checkpoints, family, pooling, normalize):
    d = checkpoints[family]
    got = assert_equal_jax(d, pooling=pooling, normalize_embeddings=normalize)
    port = TorchSentenceEncoderRM(model=d, device="cpu", max_batch_size=4)
    buckets = {ids.shape[1] for _, ids, _ in bucketed_batches(port.tokenizer, DOCS, None, 4, 512, "cpu")}
    assert len(buckets) >= 2 and got.shape == (len(DOCS), 32)


@pytest.mark.parametrize("family", FAMILIES)
def test_flax_msgpack_equals_jax(checkpoints, family, tmp_path):
    d = checkpoints[family]
    flax_dir = str(tmp_path / "flax")
    transformers.FlaxAutoModel.from_pretrained(d, from_pt=True).save_pretrained(flax_dir)
    for name in os.listdir(d):
        if not name.startswith(("model.", "config")):
            shutil.copy(os.path.join(d, name), flax_dir)
    got = assert_equal_jax(flax_dir)
    torch_file = TorchSentenceEncoderRM(model=d, device="cpu", max_batch_size=4)._embed(DOCS)
    np.testing.assert_allclose(got, torch_file, atol=1e-6, rtol=0)


@pytest.mark.parametrize("window", [None, 4096, 3])
def test_mistral_sliding_window(checkpoints, tmp_path, window):
    """Flax bands the causal mask with ``triu(causal, -(sliding_window or
    0))``: each window equals the reference.  A change to token 1 reaches
    through the 2 layers' windows to position 1 + 2 * window and no further:
    without a window a token sees only itself, so no later state moves."""
    d = str(tmp_path / "mistral")
    shutil.copytree(checkpoints["mistral"], d)
    rewrite_config(d, sliding_window=window)
    assert read_config(d).sliding_window == window
    assert_equal_jax(d)
    enc, tok = load_encoder(d), load_tokenizer(d)
    ids = torch.tensor(tok.encode([" ".join(seeded_words(7, 12))]))
    changed = ids.clone()
    changed[0, 1] = (ids[0, 1] + 1) % enc.config.vocab_size
    with torch.no_grad():
        moved = (enc(ids, torch.ones_like(ids)) - enc(changed, torch.ones_like(ids)))[0].abs().amax(-1)
    n = ids.shape[1]
    reach = min(1 + 2 * (window or 0), n - 1)
    assert n > 8 and float(moved[reach]) > 0 and bool((moved[reach + 1 :] == 0).all())


def test_rope_theta_is_ignored(checkpoints, tmp_path):
    """Flax hard-codes base 10000: a ``rope_theta`` of 500000 (Llama-3's)
    equals the reference, and the default's embeddings."""
    d = str(tmp_path / "llama")
    shutil.copytree(checkpoints["llama"], d)
    rewrite_config(d, rope_theta=500000.0, rope_scaling={"type": "linear", "factor": 4.0})
    got = assert_equal_jax(d)
    default = TorchSentenceEncoderRM(model=checkpoints["llama"], device="cpu", max_batch_size=4)._embed(DOCS)
    np.testing.assert_array_equal(got, default)


@pytest.mark.parametrize("family", FAMILIES)
def test_left_padding(checkpoints, family):
    """The tokenizers pad on the left, as ``AutoTokenizer`` does: the ids
    and masks of a bucket equal the reference's; positions stay ``arange``
    (``test_embeddings_equal_jax``), and a padded row's CLS state is a pad
    position's."""
    d = checkpoints[family]
    ref = transformers.AutoTokenizer.from_pretrained(d)
    port = load_tokenizer(d)
    assert ref.padding_side == port.padding_side == "left"
    batch = DOCS[:4]
    (_, ids, mask), = bucketed_batches(port, batch, None, 4, 512, "cpu")
    want = ref(batch, padding="max_length", truncation=True, max_length=ids.shape[1], return_tensors="np")
    np.testing.assert_array_equal(ids.numpy(), want["input_ids"])
    np.testing.assert_array_equal(mask.numpy(), want["attention_mask"])
    assert (mask[:, 0] == 0).any() and (mask[:, -1] == 1).all()


def test_gemma_hidden_activation(checkpoints, tmp_path):
    """Gemma's MLP runs the tanh GELU where ``hidden_activation`` is unset,
    whatever ``hidden_act`` says; set, it is read."""
    d = str(tmp_path / "gemma")
    shutil.copytree(checkpoints["gemma"], d)
    rewrite_config(d, hidden_act="gelu", hidden_activation=None)
    assert read_config(d).hidden_activation == "gelu_pytorch_tanh"
    tanh = assert_equal_jax(d)
    rewrite_config(d, hidden_activation="gelu")
    assert read_config(d).hidden_activation == "gelu"
    exact = assert_equal_jax(d)
    assert np.abs(tanh - exact).max() > 1e-6


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_sharded_checkpoint(checkpoints, tmp_path, fmt):
    """``save_pretrained`` with a small ``max_shard_size`` writes shards and
    an index: they load to the unsharded parameters; the reference reads
    the ``.bin`` shards (it refuses sharded safetensors) to the same
    embeddings."""
    d = checkpoints["llama"]
    sharded = str(tmp_path / "sharded")
    shutil.copytree(d, sharded, ignore=shutil.ignore_patterns("model.safetensors"))
    transformers.AutoModel.from_pretrained(d).save_pretrained(sharded, max_shard_size="20KB",
                                                              safe_serialization=fmt == "safetensors")
    index = "model.safetensors.index.json" if fmt == "safetensors" else "pytorch_model.bin.index.json"
    with open(os.path.join(sharded, index), encoding="utf-8") as f:
        assert len(set(json.load(f)["weight_map"].values())) > 2
    got, want = load_state_dict(sharded), load_state_dict(d)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    port = TorchSentenceEncoderRM(model=sharded, device="cpu", max_batch_size=4)._embed(DOCS)
    np.testing.assert_array_equal(port, TorchSentenceEncoderRM(model=d, device="cpu", max_batch_size=4)._embed(DOCS))
    if fmt == "bin":
        assert_equal_jax(sharded)
    else:
        with pytest.raises(NotImplementedError, match="sharded checkpoints using safetensors"):
            JaxSentenceEncoderRM(model=sharded)


def test_load_in_bf16(checkpoints):
    """Each tensor goes to the device in its file's dtype and is cast there:
    every parameter is bf16 and equals the file's weight cast to bf16."""
    d = checkpoints["mistral"]
    enc = load_encoder(d, dtype=torch.bfloat16)
    state = load_state_dict(d)
    params = dict(enc.named_parameters())
    assert {p.dtype for p in params.values()} == {torch.bfloat16}
    for name, p in params.items():
        assert torch.equal(p, state[name].to(torch.bfloat16)), name
    emb = TorchSentenceEncoderRM(model=d, device="cpu", dtype=torch.bfloat16, max_batch_size=4)._embed(DOCS)
    f32 = TorchSentenceEncoderRM(model=d, device="cpu", max_batch_size=4)._embed(DOCS)
    assert emb.dtype == np.float32 and float(np.sum(emb * f32, axis=1).min()) > 0.99


@pytest.mark.parametrize("family", ["llama", "mistral"])
def test_missing_pad_token_raises(tmp_path, family):
    """Llama-2's and Mistral's tokenizers as published have no pad token:
    ``padding=True`` raises ``ValueError`` in the reference, and the port
    raises it too."""
    d = str(tmp_path / family)
    write_decoder(d, family, seed=3, tokenizer_kw={"pad": None})
    with pytest.raises(ValueError, match="padding"):
        JaxSentenceEncoderRM(model=d, max_batch_size=2)._embed(DOCS[:2])
    with pytest.raises(ValueError, match="no padding token"):
        TorchSentenceEncoderRM(model=d, max_batch_size=2, device="cpu")._embed(DOCS[:2])


@pytest.mark.parametrize("family", FAMILIES)
def test_length_error_matches_reference(checkpoints, family):
    d = checkpoints[family]
    docs = ["short one", LONG]
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        JaxSentenceEncoderRM(model=d, max_batch_size=2, max_seq_length=256)._embed(docs)
    with pytest.raises(ValueError, match="256-token bucket is longer than max_position_embeddings 128"):
        TorchSentenceEncoderRM(model=d, max_batch_size=2, max_seq_length=256, device="cpu")._embed(docs)


@pytest.mark.parametrize("family", FAMILIES)
def test_reranker_refused(checkpoints, family):
    d = checkpoints[family]
    with pytest.raises(ValueError, match="Unrecognized configuration class"):
        transformers.FlaxAutoModelForSequenceClassification.from_pretrained(d, from_pt=True)
    with pytest.raises(ValueError, match=f"model_type '{family}' has no sequence classifier"):
        TorchCrossEncoderReranker(model=d, device="cpu")
