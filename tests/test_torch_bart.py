"""BART and mBART in the port (``bart.py``, ``mbart.py``, loaded through
``auto.py``) against the JAX package's classes on tiny checkpoints (width
32, 2 + 2 layers, 128 positions) saved with ``save_pretrained``, weights
drawn wide (std 0.2) so outputs spread:

- ``TorchSentenceEncoderRM(device="cpu")`` equals ``JaxSentenceEncoderRM``
  within 1e-5 for mean and CLS pooling, normalised and not, over a padded
  last batch (``""`` rows) and two sequence buckets;
- ``TorchCrossEncoderReranker`` equals ``JaxCrossEncoderReranker`` within
  1e-5 with one and two labels;
- the eos-sum quirk: under the reference's ``jit`` Flax sums the decoder
  states at every ``</s>`` of a row; the port equals that and differs from
  the eager Flax model, which keeps only the last ``</s>``;
- both shifts (BART's start token, mBART's last non-pad token) against
  Flax's ``shift_tokens_right``;
- ``from_flax_params`` of the Flax model's own parameters gives its outputs
  within 1e-5, encoder-decoder and classifier;
- the checkpoint formats: safetensors, ``pytorch_model.bin`` with the tied
  embeddings left out (``shared`` alone, or the two ``embed_tokens`` alone),
  ``flax_model.msgpack`` and a ``*ForConditionalGeneration`` file
  (``model.`` prefix, ``lm_head``, ``final_logits_bias``) give the same
  embeddings;
- a bucket past ``max_position_embeddings`` raises ``ValueError`` in both.
"""

import os

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from torch_families import SEQ2SEQ_CLASSIFIERS, seeded_texts, seeded_words, write_seq2seq  # noqa: E402

from lotus_tpu.models import JaxCrossEncoderReranker, JaxSentenceEncoderRM  # noqa: E402
from lotus_tpu_torch.models import (  # noqa: E402
    TorchCrossEncoderReranker, TorchSentenceEncoderRM, from_flax_params, load_encoder,
)
from lotus_tpu_torch.models.bart import shift_tokens_right  # noqa: E402
from lotus_tpu_torch.models.checkpoint import new_module, read_config  # noqa: E402
from lotus_tpu_torch.models.mbart import shift_tokens_right as mbart_shift  # noqa: E402
from lotus_tpu_torch.models.torch_rm import bucketed_batches  # noqa: E402

DOCS = seeded_texts(5, 6, seeded_words(0, 200), 1, 6) + ["", " ".join(seeded_words(1, 14)), "Hello, WORLD! naïve ①"]
QUERY = "hello world " + " ".join(seeded_words(0, 3))
LONG = " ".join(seeded_words(2, 200))  # past 128 tokens in every tokenizer


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Per family: (encoder-decoder directory, 1-label directory, 2-label directory)."""
    out = {}
    for family in SEQ2SEQ_CLASSIFIERS:
        dirs = [str(tmp_path_factory.mktemp(f"{family}-{tag}")) for tag in ("rm", "rr1", "rr2")]
        write_seq2seq(dirs[0], family, seed=3, init_std=0.2)
        for labels, d in ((1, dirs[1]), (2, dirs[2])):
            write_seq2seq(d, family, num_labels=labels, seed=4 + labels, init_std=0.2)
        out[family] = dirs
    return out


@pytest.mark.parametrize("family", SEQ2SEQ_CLASSIFIERS)
@pytest.mark.parametrize("pooling,normalize", [("mean", True), ("mean", False), ("cls", True), ("cls", False)])
def test_embeddings_equal_jax(checkpoints, family, pooling, normalize):
    d = checkpoints[family][0]
    kw = dict(max_batch_size=4, pooling=pooling, normalize_embeddings=normalize)
    want = JaxSentenceEncoderRM(model=d, **kw)._embed(DOCS)
    port = TorchSentenceEncoderRM(model=d, device="cpu", **kw)
    got = port._embed(DOCS)
    buckets = {ids.shape[1] for _, ids, _ in bucketed_batches(port.tokenizer, DOCS, None, 4, 512, "cpu")}
    assert len(buckets) >= 2 and got.shape == want.shape == (len(DOCS), 32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("family", SEQ2SEQ_CLASSIFIERS)
@pytest.mark.parametrize("labels", [1, 2])
def test_reranker_equal_jax(checkpoints, family, labels):
    d = checkpoints[family][labels]
    want = JaxCrossEncoderReranker(model=d, max_batch_size=4).score_pairs(QUERY, DOCS)
    port = TorchCrossEncoderReranker(model=d, max_batch_size=4, device="cpu")
    got = port.score_pairs(QUERY, DOCS)
    assert got.shape == (len(DOCS),) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert port(QUERY, DOCS, 3).indices == JaxCrossEncoderReranker(model=d, max_batch_size=4)(QUERY, DOCS, 3).indices


@pytest.mark.parametrize("family", SEQ2SEQ_CLASSIFIERS)
def test_eos_sum_quirk(checkpoints, family):
    """Every row holds the same number of ``</s>`` (three in BART's pair
    template; mBART's pair has one, so each doc carries one more), so the
    eager Flax model, which keeps only the last of them, runs too."""
    d = checkpoints[family][1]
    docs = [t + (" </s> tail" if family == "mbart" else "") for t in DOCS if t]
    port = TorchCrossEncoderReranker(model=d, max_batch_size=len(docs), device="cpu")
    got = port.score_pairs(QUERY, docs)
    want = JaxCrossEncoderReranker(model=d, max_batch_size=len(docs)).score_pairs(QUERY, docs)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    _, ids, mask = next(bucketed_batches(port.tokenizer, [QUERY] * len(docs), docs, len(docs), 512, "cpu"))
    eos = read_config(d).eos_token_id
    counts = (ids == eos).sum(1)
    assert int(counts.min()) == int(counts.max()) >= 2
    flax = transformers.FlaxAutoModelForSequenceClassification.from_pretrained(d, from_pt=True)
    last = np.asarray(flax(input_ids=ids.numpy(), attention_mask=mask.numpy()).logits)[:, 0]
    with torch.no_grad():  # the port's decoder states, pooled at the last </s> only
        hidden = port.model.model(ids, mask)
        at = ids.shape[1] - 1 - torch.flip((ids == eos).int(), [1]).argmax(1)
        mine = port.model.classification_head(hidden[torch.arange(len(docs)), at])[:, 0].numpy()
    np.testing.assert_allclose(last, mine, atol=1e-5, rtol=0)
    assert float(np.abs(got - last).min()) > 1e-4, "the all-</s> sum should differ from the last </s> in every row"


def test_shifts():
    from transformers.models.bart.modeling_flax_bart import shift_tokens_right as flax_shift
    from transformers.models.mbart.modeling_flax_mbart import shift_tokens_right as flax_mbart_shift

    rng = np.random.default_rng(0)
    ids = rng.integers(3, 50, (6, 9))
    for r, n in enumerate((9, 7, 3, 1, 0, 5)):  # pads (1) on the right; a row of pads takes its last
        ids[r, n:] = 1
    got = shift_tokens_right(torch.from_numpy(ids), 2).numpy()
    np.testing.assert_array_equal(got, np.asarray(flax_shift(ids, 1, 2)))
    got = mbart_shift(torch.from_numpy(ids), 1).numpy()
    np.testing.assert_array_equal(got, np.asarray(flax_mbart_shift(ids, 1)))
    assert got[1, 0] == ids[1, 6] and got[4, 0] == 1


@pytest.mark.parametrize("family", SEQ2SEQ_CLASSIFIERS)
def test_from_flax_params(checkpoints, family):
    """One ``</s>`` a row, so the eager Flax head (last ``</s>``) and the
    sum agree."""
    ids = np.array([[0, 17, 40, 23, 2, 1, 1], [0, 5, 6, 7, 8, 9, 2]])
    mask = (ids != 1).astype(np.int64)
    for d, auto in ((checkpoints[family][0], transformers.FlaxAutoModel),
                    (checkpoints[family][2], transformers.FlaxAutoModelForSequenceClassification)):
        classifier = auto is not transformers.FlaxAutoModel
        flax = auto.from_pretrained(d, from_pt=True)
        out = flax(input_ids=ids, attention_mask=mask)
        want = np.asarray(out.logits if classifier else out.last_hidden_state)
        config = read_config(d)
        with torch.device("meta"):
            module = new_module(config, classifier=classifier)
        module.load_state_dict(from_flax_params(flax.params, config), assign=True)
        with torch.no_grad():
            got = module.eval()(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _bin(src: str, dst: str, drop: tuple[str, ...]) -> None:
    """``src``'s weights as ``pytorch_model.bin`` in ``dst`` without ``drop``."""
    import shutil

    shutil.copytree(src, dst)
    os.remove(os.path.join(dst, "model.safetensors"))
    state = {k: v for k, v in transformers.AutoModel.from_pretrained(src).state_dict().items() if k not in drop}
    torch.save(state, os.path.join(dst, "pytorch_model.bin"))


@pytest.mark.parametrize("family", SEQ2SEQ_CLASSIFIERS)
def test_checkpoint_formats(checkpoints, family, tmp_path):
    import shutil

    d = checkpoints[family][0]
    want = TorchSentenceEncoderRM(model=d, max_batch_size=4, device="cpu")._embed(DOCS)
    tied = ("encoder.embed_tokens.weight", "decoder.embed_tokens.weight")
    dirs = {}
    dirs["bin-shared"] = str(tmp_path / "bin-shared")
    _bin(d, dirs["bin-shared"], tied)
    dirs["bin-embed-tokens"] = str(tmp_path / "bin-embed-tokens")
    _bin(d, dirs["bin-embed-tokens"], ("shared.weight",))
    dirs["flax"] = str(tmp_path / "flax")
    shutil.copytree(d, dirs["flax"])
    os.remove(os.path.join(dirs["flax"], "model.safetensors"))
    transformers.FlaxAutoModel.from_pretrained(d, from_pt=True).save_pretrained(dirs["flax"])
    dirs["generation"] = str(tmp_path / "generation")
    shutil.copytree(d, dirs["generation"])
    gen = transformers.AutoModelForSeq2SeqLM.from_pretrained(d)
    gen.save_pretrained(dirs["generation"])
    names = set(torch.load(os.path.join(dirs["bin-embed-tokens"], "pytorch_model.bin"), weights_only=True))
    assert "shared.weight" not in names and set(tied) <= names
    for name, path in dirs.items():
        got = TorchSentenceEncoderRM(model=path, max_batch_size=4, device="cpu")._embed(DOCS)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=name)
    with pytest.raises(KeyError, match="lacks"):  # a classifier needs its head
        load_encoder(d, classifier=True)


@pytest.mark.parametrize("family", SEQ2SEQ_CLASSIFIERS)
def test_length_error_matches_reference(checkpoints, family):
    d = checkpoints[family][0]
    docs = ["short one", LONG]
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        JaxSentenceEncoderRM(model=d, max_batch_size=2, max_seq_length=256)._embed(docs)
    with pytest.raises(ValueError, match="256-token bucket is longer than max_position_embeddings 128"):
        TorchSentenceEncoderRM(model=d, max_batch_size=2, max_seq_length=256, device="cpu")._embed(docs)
    # At 128 tokens, the cap, both run.
    want = JaxSentenceEncoderRM(model=d, max_batch_size=2, max_seq_length=128)._embed(docs)
    got = TorchSentenceEncoderRM(model=d, max_batch_size=2, max_seq_length=128, device="cpu")._embed(docs)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
