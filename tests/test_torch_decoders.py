"""GPT-2, GPT-Neo and GPT-J in the port (``gpt2.py``, ``gpt_neo.py``,
``gptj.py``), which the reference runs as RMs only, against the JAX
package's classes on tiny checkpoints (width 32, 2 layers, 4 heads, 128
positions, weights of std 0.2) saved with ``save_pretrained``:

- ``TorchSentenceEncoderRM(device="cpu")`` equals ``JaxSentenceEncoderRM``
  within 1e-5 for mean and CLS pooling, normalised and not, over a padded
  last batch (``""`` rows) and two sequence buckets, from the torch file
  and from ``flax_model.msgpack`` (Flax's (out, in) ``Conv1D`` kernels for
  GPT-2);
- GPT-2's ``Conv1D`` layout read from a ``GPT2LMHeadModel``'s
  ``pytorch_model.bin`` (the ``transformer.`` prefix, ``lm_head`` and the
  old causal-mask buffers beside it), in the zip format and in the legacy
  one GPT-2's first files were saved in;
- GPT-Neo's local layers: all-local and all-global configs each equal the
  reference, and differ from each other at the 4-token window;
- GPT-J's rotary over ``rotary_dim`` 4 of a head's 8 dims, and over all 8:
  each equals the reference, and they differ;
- no pad token (GPT-2's tokenizer as published) raises ``ValueError`` in
  both packages; a bucket past ``n_positions`` raises ``ValueError`` in
  both; a reranker on these types is refused as the Flax auto class
  refuses it.
"""

import os
import shutil

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from torch_families import DECODERS, seeded_texts, seeded_words, write_decoder  # noqa: E402

from lotus_tpu.models import JaxSentenceEncoderRM  # noqa: E402
from lotus_tpu_torch.models import TorchCrossEncoderReranker, TorchSentenceEncoderRM, load_encoder  # noqa: E402
from lotus_tpu_torch.models.torch_rm import bucketed_batches  # noqa: E402

FAMILIES = DECODERS[:3]  # gpt2, gpt_neo, gptj
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
    """A directory with only ``flax_model.msgpack`` (and the tokenizer)
    gives the reference's embeddings, and the torch file's."""
    d = checkpoints[family]
    flax_dir = str(tmp_path / "flax")
    transformers.FlaxAutoModel.from_pretrained(d, from_pt=True).save_pretrained(flax_dir)
    for name in os.listdir(d):
        if not name.startswith(("model.", "config")):
            shutil.copy(os.path.join(d, name), flax_dir)
    assert not os.path.exists(os.path.join(flax_dir, "model.safetensors"))
    got = assert_equal_jax(flax_dir)
    torch_file = TorchSentenceEncoderRM(model=d, device="cpu", max_batch_size=4)._embed(DOCS)
    np.testing.assert_allclose(got, torch_file, atol=1e-6, rtol=0)


@pytest.mark.parametrize("zip_format", [True, False])
def test_gpt2_lm_head_bin(checkpoints, tmp_path, zip_format):
    """A ``GPT2LMHeadModel``'s ``pytorch_model.bin`` (``transformer.``
    prefix, tied ``lm_head``, the old ``attn.bias`` / ``attn.masked_bias``
    buffers), saved in the zip format or the legacy one (which cannot be
    memory-mapped), loads the same ``Conv1D`` weights."""
    d = checkpoints["gpt2"]
    lm_dir = str(tmp_path / "lm")
    shutil.copytree(d, lm_dir)
    os.remove(os.path.join(lm_dir, "model.safetensors"))
    lm = transformers.GPT2LMHeadModel(transformers.AutoConfig.from_pretrained(d))
    lm.transformer.load_state_dict(transformers.AutoModel.from_pretrained(d).state_dict())
    state = {k: v.contiguous() for k, v in lm.state_dict().items()}
    for i in range(2):
        state[f"transformer.h.{i}.attn.bias"] = torch.ones(1, 1, 128, 128).tril()
        state[f"transformer.h.{i}.attn.masked_bias"] = torch.tensor(-1e4)
    torch.save(state, os.path.join(lm_dir, "pytorch_model.bin"), _use_new_zipfile_serialization=zip_format)
    got = load_encoder(lm_dir).state_dict()
    want = load_encoder(d).state_dict()
    assert got.keys() == want.keys() and "h.0.attn.c_attn.weight" in got
    assert tuple(got["h.0.attn.c_attn.weight"].shape) == (32, 96)  # (in, out), as torch's Conv1D stores it
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert_equal_jax(lm_dir, docs=DOCS[:4])


@pytest.mark.parametrize("kinds", ["local", "global"])
def test_gpt_neo_local_layers(tmp_path, kinds):
    """Every layer local (a 4-token window) or every layer global: each
    equals the reference; the two differ wherever a text passes 4 tokens."""
    outs = {}
    for k in (kinds, "global" if kinds == "local" else "local"):
        d = str(tmp_path / k)
        write_decoder(d, "gpt_neo", seed=5, init_range=0.2, attention_types=[[[k], 2]])
        outs[k] = TorchSentenceEncoderRM(model=d, device="cpu", max_batch_size=4)._embed(DOCS)
    assert_equal_jax(str(tmp_path / kinds))
    long_rows = [i for i, t in enumerate(DOCS) if len(t.split()) > 4]
    assert np.abs(outs["local"][long_rows] - outs["global"][long_rows]).max() > 1e-3


def test_gptj_partial_rotary(tmp_path):
    """``rotary_dim`` 4 of the head's 8 dims and all 8: each equals the
    reference; the two differ."""
    outs = {}
    for rot in (4, 8):
        d = str(tmp_path / f"rot{rot}")
        write_decoder(d, "gptj", seed=6, init_range=0.2, rotary_dim=rot)
        outs[rot] = assert_equal_jax(d)
    assert np.abs(outs[4] - outs[8]).max() > 1e-3


@pytest.mark.parametrize("family", FAMILIES)
def test_missing_pad_token_raises(tmp_path, family):
    """GPT-2's tokenizer as published has no pad token: ``padding=True``
    raises ``ValueError`` in the reference, and the port raises it too."""
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
