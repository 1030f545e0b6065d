"""``TorchSentenceEncoderRM`` against ``JaxSentenceEncoderRM`` on one tiny
BERT checkpoint directory (hidden 32, 2 layers, as
``tests/test_flax_rm.py`` builds it): within 1e-5 in f32 over mean and CLS
pooling, normalised and not, a padded last batch and two sequence buckets;
``_embed([])``, query coercion, and no silent CPU fallback."""

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

from test_torch_checkpoints import write_bert  # noqa: E402

from lotus_tpu.models import JaxSentenceEncoderRM  # noqa: E402
from lotus_tpu_torch.models import TorchSentenceEncoderRM  # noqa: E402
from lotus_tpu_torch.models.torch_rm import seq_bucket  # noqa: E402

# Two sequence buckets (16 and 32 tokens) and, at max_batch_size 4, a padded
# last batch.
DOCS = ["the cat sat on the mat", "hello world", "dogs", "a dog sat", "hello hello cat",
        " ".join(["the cat"] * 10), "", "Unknown Words, punctuation!"]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tiny_bert"))
    write_bert(d)
    return d


@pytest.mark.parametrize("pooling", ["mean", "cls"])
@pytest.mark.parametrize("normalize", [True, False])
def test_embeddings_equal_jax(checkpoint, pooling, normalize):
    kw = dict(max_batch_size=4, pooling=pooling, normalize_embeddings=normalize)
    want = JaxSentenceEncoderRM(model=checkpoint, **kw)._embed(DOCS)
    port = TorchSentenceEncoderRM(model=checkpoint, device="cpu", **kw)
    got = port._embed(DOCS)
    assert got.dtype == np.float32 and got.shape == want.shape == (len(DOCS), 32)
    np.testing.assert_allclose(got, want, atol=1e-5)
    lengths = [len(ids) for ids in port.tokenizer.encode(DOCS, max_length=port.max_seq_length)]
    assert sorted({seq_bucket(max(lengths[i : i + 4]), 512) for i in (0, 4)}) == [16, 32]


def test_empty_query_coercion_and_device(checkpoint):
    ref = JaxSentenceEncoderRM(model=checkpoint, max_batch_size=4)
    port = TorchSentenceEncoderRM(model=checkpoint, max_batch_size=4, device="cpu")
    assert port._embed([]).shape == (0, 32) and port._embed([]).dtype == np.float32
    for q in ("hello world", ["hello world", "dogs"], np.str_("dogs")):
        np.testing.assert_allclose(port.convert_query_to_query_vector(q),
                                   ref.convert_query_to_query_vector(q), atol=1e-5)
    import pandas as pd

    series = pd.Series(["a dog sat", "the mat"])
    np.testing.assert_allclose(port.convert_query_to_query_vector(series),
                               ref.convert_query_to_query_vector(series), atol=1e-5)
    vecs = np.ones((2, 32), np.float32)
    assert port.convert_query_to_query_vector(vecs) is vecs
    np.testing.assert_allclose(port(DOCS[:3]), ref(DOCS[:3]), atol=1e-5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchSentenceEncoderRM(model=checkpoint)


def test_bfloat16_is_close_and_f32_out(checkpoint):
    """``dtype=torch.bfloat16`` runs the forward in bf16 and returns f32
    embeddings close to f32's (cosine >= 0.99)."""
    f32 = TorchSentenceEncoderRM(model=checkpoint, device="cpu")._embed(DOCS)
    bf16 = TorchSentenceEncoderRM(model=checkpoint, device="cpu", dtype=torch.bfloat16)._embed(DOCS)
    assert bf16.dtype == np.float32
    assert (np.sum(f32 * bf16, axis=1) >= 0.99).all()


def test_pooling_is_checked(checkpoint):
    with pytest.raises(ValueError, match="pooling"):
        TorchSentenceEncoderRM(model=checkpoint, pooling="max", device="cpu")
