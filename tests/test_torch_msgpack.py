"""The port's Flax msgpack reader (``lotus_tpu_torch/models/msgpack.py``,
through ``checkpoint.load_state_dict``): a ``FlaxBertModel`` and a
``FlaxXLMRobertaModel`` (and an XLM-R sequence classifier) saved as
``flax_model.msgpack`` only load in the port and give the JAX classes'
outputs, which read the same file natively; so do the pretraining models
most public Flax files hold (``FlaxBertForPreTraining``,
``FlaxRobertaForMaskedLM``, ``FlaxElectraForPreTraining``,
``FlaxDistilBertForMaskedLM``, ``FlaxAlbertForPreTraining``,
``FlaxRoFormerForMaskedLM``, ``FlaxBigBirdForPreTraining``,
``FlaxRobertaPreLayerNormForMaskedLM``: the family's prefix and a head the
encoder drops); ALBERT's shared groups, RoFormer (no position table in a
Flax file), BigBird and RoBERTa-PreLayerNorm (its top-level ``LayerNorm``)
as msgpack alone; a leaf above Flax's chunk size
is rebuilt (the test lowers ``flax.serialization.MAX_CHUNK_SIZE`` in its
own process; nothing in ``lotus_tpu`` changes); the decoder agrees with the
``msgpack`` package on every type Flax writes; a truncated or malformed
file raises ``ValueError`` naming it."""

import os
import shutil

import numpy as np
import pytest

transformers = pytest.importorskip("transformers")
msgpack = pytest.importorskip("msgpack")

from test_torch_checkpoints import write_bert  # noqa: E402
from torch_families import write_family  # noqa: E402

from lotus_tpu.models import JaxCrossEncoderReranker, JaxSentenceEncoderRM  # noqa: E402
from lotus_tpu_torch.models import TorchCrossEncoderReranker, TorchSentenceEncoderRM, load_state_dict  # noqa: E402
from lotus_tpu_torch.models.msgpack import unpackb  # noqa: E402

DOCS = ["the cat sat on the mat", "hello world", "", "dogs and a mat", "Unknown Words, punctuation!",
        " ".join(["hello cat"] * 9)]


def flax_only(torch_dir: str, out: str, classifier: bool = False, flax_class=None) -> str:
    """``out`` with the tokenizer files and config of ``torch_dir`` and the
    Flax model (``flax_class``, else the auto class) converted from its
    weights, saved as ``flax_model.msgpack`` alone."""
    auto = transformers.FlaxAutoModelForSequenceClassification if classifier else transformers.FlaxAutoModel
    (flax_class or auto).from_pretrained(torch_dir, from_pt=True).save_pretrained(out)
    for name in os.listdir(torch_dir):
        if name not in ("model.safetensors", "pytorch_model.bin") and not os.path.exists(os.path.join(out, name)):
            shutil.copy(os.path.join(torch_dir, name), out)
    assert sorted(n for n in os.listdir(out) if "model" in n and not n.endswith(".json")) == ["flax_model.msgpack"]
    return out


@pytest.mark.parametrize("family", ["bert", "xlm-roberta", "albert", "roformer", "big_bird", "roberta-prelayernorm"])
def test_msgpack_only_directories_give_the_jax_embeddings(tmp_path, family):
    src = str(tmp_path / "torch")
    if family == "bert":
        write_bert(src, init_range=0.2)
    elif family == "albert":  # 3 layers over 2 shared groups of 2
        write_family(src, family, init_range=0.2, num_hidden_layers=3, num_hidden_groups=2, inner_group_num=2)
    else:
        write_family(src, family, init_range=0.2)
    d = flax_only(src, str(tmp_path / "flax"))
    want = JaxSentenceEncoderRM(model=d, max_batch_size=4)._embed(DOCS)
    got = TorchSentenceEncoderRM(model=d, max_batch_size=4, device="cpu")._embed(DOCS)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.ptp(got) > 0.1


@pytest.mark.parametrize("family, flax_class, prefix", [
    ("bert", "FlaxBertForPreTraining", "bert"), ("roberta", "FlaxRobertaForMaskedLM", "roberta"),
    ("electra", "FlaxElectraForPreTraining", "electra"), ("distilbert", "FlaxDistilBertForMaskedLM", "distilbert"),
    ("albert", "FlaxAlbertForPreTraining", "albert"), ("roformer", "FlaxRoFormerForMaskedLM", "roformer"),
    ("big_bird", "FlaxBigBirdForPreTraining", "bert"),
    ("roberta-prelayernorm", "FlaxRobertaPreLayerNormForMaskedLM", "roberta_prelayernorm"),
])
def test_msgpack_pretraining_heads_give_the_jax_embeddings(tmp_path, family, flax_class, prefix):
    """A msgpack-only directory of a pretraining model: its leaves sit under
    the family's prefix beside a head; the port strips the one and drops the
    other, as ``FlaxAutoModel`` does, and embeds as the JAX RM."""
    src = str(tmp_path / "torch")
    if family == "bert":
        write_bert(src, init_range=0.2)
    else:
        write_family(src, family, init_range=0.2)
    d = flax_only(src, str(tmp_path / "flax"), flax_class=getattr(transformers, flax_class))
    names = set(load_state_dict(d))
    assert all(n.startswith(prefix + ".") for n in names if "embeddings" in n)
    assert any(not n.startswith(prefix + ".") for n in names)  # the head
    want = JaxSentenceEncoderRM(model=d, max_batch_size=4)._embed(DOCS)
    got = TorchSentenceEncoderRM(model=d, max_batch_size=4, device="cpu")._embed(DOCS)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.ptp(got) > 0.1


def test_msgpack_classifier_gives_the_jax_scores(tmp_path):
    src = str(tmp_path / "torch")
    write_family(src, "xlm-roberta", num_labels=1, seed=2, init_range=0.2)
    d = flax_only(src, str(tmp_path / "flax"), classifier=True)
    want = JaxCrossEncoderReranker(model=d, max_batch_size=4).score_pairs("hello cat", DOCS)
    got = TorchCrossEncoderReranker(model=d, max_batch_size=4, device="cpu").score_pairs("hello cat", DOCS)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_chunked_leaves_are_rebuilt(tmp_path, monkeypatch):
    """With Flax's chunk size lowered to 1 KiB, the word-embedding table (and
    every other leaf above it) is written as a ``__msgpack_chunked_array__``
    dict of flat chunks; the reader joins them back."""
    import flax.serialization

    src = str(tmp_path / "torch")
    write_bert(src, init_range=0.2)
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 1024)
    d = flax_only(src, str(tmp_path / "flax"))
    monkeypatch.undo()
    raw = open(os.path.join(d, "flax_model.msgpack"), "rb").read()
    assert b"__msgpack_chunked_array__" in raw
    state = load_state_dict(d)
    want = transformers.BertModel.from_pretrained(src).state_dict()
    emb = state["embeddings.word_embeddings.weight"]
    assert emb.numel() * 4 > 1024 and np.array_equal(emb.numpy(), want["embeddings.word_embeddings.weight"].numpy())
    got = TorchSentenceEncoderRM(model=d, max_batch_size=4, device="cpu")._embed(DOCS)
    np.testing.assert_allclose(got, JaxSentenceEncoderRM(model=d, max_batch_size=4)._embed(DOCS), atol=1e-5)


def test_decoder_agrees_with_msgpack():
    """Every width of int, float32/64, str, bin, array and map, nil, bool,
    and Flax's ndarray and scalar exts (f32, f16, bf16, int8, int64)."""
    import flax.serialization
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    plain = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63 - 1, -1, -32, -33, -128, -129,
                 -32768, -32769, -2**31, -2**31 - 1, -2**63],
        "floats": [0.0, -1.5, 1e300, float("inf")], "none": None, "bools": [True, False],
        "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000], "bin": b"\x00\x01" * 40000,
        "long": list(range(70000)), "wide": {str(i): i for i in range(20)},
    }
    assert unpackb(msgpack.packb(plain, use_bin_type=True)) == {**plain, "bin": memoryview(plain["bin"])}
    assert unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5
    arrays = {"f32": rng.standard_normal((3, 5)).astype(np.float32), "f16": rng.standard_normal(7).astype(np.float16),
              "i8": rng.integers(-128, 127, (4, 4), dtype=np.int8), "i64": np.arange(5, dtype=np.int64),
              "scalar": np.float32(2.5), "nested": {"bf16": np.asarray(jnp.asarray([1.5, -2.25, 3e38], jnp.bfloat16))}}
    got = unpackb(flax.serialization.msgpack_serialize(arrays))
    for k in ("f32", "f16", "i8", "i64"):
        assert got[k].dtype == arrays[k].dtype and np.array_equal(got[k], arrays[k])
    assert got["scalar"] == 2.5
    np.testing.assert_array_equal(got["nested"]["bf16"], np.asarray(arrays["nested"]["bf16"], np.float32))


def test_truncated_and_malformed_files_raise(tmp_path):
    src = str(tmp_path / "torch")
    write_bert(src)
    d = flax_only(src, str(tmp_path / "flax"))
    path = os.path.join(d, "flax_model.msgpack")
    raw = open(path, "rb").read()
    for blob in (raw[: len(raw) // 2], raw[:-1], raw + b"\x00", b"\x93\x01\x02\x03", b"\xc7\x01\x09\x00"):
        with open(path, "wb") as f:
            f.write(blob)
        with pytest.raises(ValueError, match="flax_model.msgpack"):
            load_state_dict(d)
