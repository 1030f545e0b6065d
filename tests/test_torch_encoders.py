"""The encoder families past BERT in the port (``roberta.py``,
``distilbert.py``, ``electra.py``, ``albert.py``, ``roformer.py``,
``big_bird.py`` at ``original_full``, ``roberta_prelayernorm.py``, loaded
through ``auto.py``) against the JAX package's classes on tiny checkpoints
(width 32, 2 layers) saved with ``save_pretrained``, weights drawn wide
(std 0.2) so outputs spread (BigBird's block-sparse attention is
``test_torch_big_bird.py``'s):

- ``TorchSentenceEncoderRM(device="cpu")`` equals ``JaxSentenceEncoderRM``
  within 1e-5 for mean and CLS pooling, normalised and not, over a padded
  last batch and two sequence buckets;
- ``TorchCrossEncoderReranker`` equals ``JaxCrossEncoderReranker`` within
  1e-5 with one and two labels;
- ``from_flax_params`` of the Flax model's own parameters gives its outputs
  within 1e-5, encoder and classifier;
- the variants: ELECTRA with ``embedding_size`` below the hidden size
  (``embeddings_project``), DistilBERT with sinusoidal positions, ALBERT
  with 3 layers over 2 shared groups of 2 inner layers, RoFormer with
  ``rotary_value``, RoBERTa at a 512-token bucket (positions up to 513);
- RoFormer with ``embedding_size`` other than the hidden size, which the
  reference cannot load, is refused; a torch checkpoint's sinusoid table is
  held to the computed one;
- ELECTRA's segment quirk, beside BERT's in ``test_torch_reranker.py``: the
  reference passes no segment ids, and Flax ELECTRA then puts every token in
  segment 1, so both differ from the torch model given the pair's segment
  ids (or all zeros)."""

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from torch_families import FAMILIES, seeded_texts, seeded_words, write_family  # noqa: E402

from lotus_tpu.models import JaxCrossEncoderReranker, JaxSentenceEncoderRM  # noqa: E402
from lotus_tpu_torch.models import (  # noqa: E402
    TorchCrossEncoderReranker, TorchSentenceEncoderRM, encoder_config, from_flax_params, load_encoder,
)
from lotus_tpu_torch.models.checkpoint import new_module, read_config  # noqa: E402
from lotus_tpu_torch.models.torch_rm import seq_bucket  # noqa: E402

# Each variant: (family, extra config).
VARIANTS = {
    **{f: (f, {}) for f in FAMILIES},
    "electra-factorized": ("electra", {"embedding_size": 16}),
    "distilbert-sinusoidal": ("distilbert", {"sinusoidal_pos_embds": True}),
    "albert-groups": ("albert", {"num_hidden_layers": 3, "num_hidden_groups": 2, "inner_group_num": 2}),
    "roformer-rotary-value": ("roformer", {"rotary_value": True}),
}
DOCS = seeded_texts(5, 6, seeded_words(0, 200), 1, 6) + ["", " ".join(seeded_words(1, 14)), "Hello, WORLD! naïve ①"]
QUERY = "hello world " + " ".join(seeded_words(0, 3))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Per variant: (encoder directory, 1-label directory, 2-label directory)."""
    out = {}
    for name, (family, kw) in VARIANTS.items():
        dirs = [str(tmp_path_factory.mktemp(f"{name}-{tag}")) for tag in ("rm", "rr1", "rr2")]
        write_family(dirs[0], family, seed=3, init_range=0.2, **kw)
        for labels, d in ((1, dirs[1]), (2, dirs[2])):
            write_family(d, family, num_labels=labels, seed=4 + labels, init_range=0.2, **kw)
        out[name] = dirs
    return out


# Every family in each pooling mode, normalised and not; the variants at the
# default (mean, normalised).
RM_CASES = [(f, p, n) for f in FAMILIES for p in ("mean", "cls") for n in (True, False)] + [
    (v, "mean", True) for v in VARIANTS if v not in FAMILIES]


@pytest.mark.parametrize("variant,pooling,normalize", RM_CASES)
def test_embeddings_equal_jax(checkpoints, variant, pooling, normalize):
    d = checkpoints[variant][0]
    kw = dict(max_batch_size=4, pooling=pooling, normalize_embeddings=normalize)
    want = JaxSentenceEncoderRM(model=d, **kw)._embed(DOCS)
    port = TorchSentenceEncoderRM(model=d, device="cpu", **kw)
    got = port._embed(DOCS)
    assert got.dtype == np.float32 and got.shape == want.shape == (len(DOCS), 32)
    np.testing.assert_allclose(got, want, atol=1e-5)
    lengths = [len(ids) for ids in port.tokenizer.encode(DOCS, max_length=port.max_seq_length)]
    assert len({seq_bucket(max(lengths[i : i + 4]), 512) for i in range(0, len(DOCS), 4)}) >= 2
    assert np.ptp(got) > 0.1


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("num_labels", [1, 2])
def test_scores_equal_jax(checkpoints, variant, num_labels):
    d = checkpoints[variant][num_labels]
    want = JaxCrossEncoderReranker(model=d, max_batch_size=4).score_pairs(QUERY, DOCS)
    port = TorchCrossEncoderReranker(model=d, max_batch_size=4, device="cpu")
    got = port.score_pairs(QUERY, DOCS)
    assert got.dtype == np.float32 and got.shape == (len(DOCS),)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.ptp(got) > 0.1
    assert port(QUERY, DOCS, K=3).indices == [int(i) for i in np.argsort(-got, kind="stable")[:3]]


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("classifier", [False, True])
def test_from_flax_params_gives_flax_outputs(checkpoints, variant, classifier):
    """The Flax model's ``last_hidden_state`` (or logits) from its own
    parameters equals the port's forward on ``from_flax_params`` of them."""
    import jax

    d = checkpoints[variant][2 if classifier else 0]
    auto = transformers.FlaxAutoModelForSequenceClassification if classifier else transformers.FlaxAutoModel
    flax = auto.from_pretrained(d, from_pt=True)
    cfg = read_config(d)
    port = new_module(cfg, classifier, pooler=True).eval()
    port.load_state_dict(from_flax_params(jax.tree_util.tree_map(np.asarray, flax.params), cfg))
    tok = transformers.AutoTokenizer.from_pretrained(d)
    enc = tok(DOCS[:5], padding=True, return_tensors="np")
    out = flax(input_ids=enc["input_ids"], attention_mask=enc["attention_mask"], params=flax.params, train=False)
    want = np.asarray(out.logits if classifier else out.last_hidden_state)
    with torch.no_grad():
        got = port(torch.from_numpy(enc["input_ids"]), torch.from_numpy(enc["attention_mask"])).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_roberta_at_a_512_token_bucket(tmp_path):
    """Pads carry id 1, so a real token's position does not move with the
    padding: a 512-token bucket reaches position 513 of 514."""
    write_family(str(tmp_path), "roberta", seed=9, init_range=0.2, max_position_embeddings=512)
    docs = [" ".join(seeded_words(7, 400)), "short text", ""]
    want = JaxSentenceEncoderRM(model=str(tmp_path), max_batch_size=4)._embed(docs)
    port = TorchSentenceEncoderRM(model=str(tmp_path), max_batch_size=4, device="cpu")
    assert max(len(ids) for ids in port.tokenizer.encode(docs, max_length=512)) == 512
    np.testing.assert_allclose(port._embed(docs), want, atol=1e-5)
    assert encoder_config({"model_type": "roberta", "max_position_embeddings": 514}).pad_token_id == 1


def test_electra_segment_quirk(checkpoints):
    """The reference passes no segment ids, and Flax ELECTRA then gives
    every token segment 1 (BERT's zeroes them): the port's scores equal the
    torch model's with all-one token types, and differ from its scores with
    all-zero ones and with the pair's segments as sentence-transformers'
    ``CrossEncoder`` passes them."""
    d = checkpoints["electra"][2]
    got = TorchCrossEncoderReranker(model=d, max_batch_size=4, device="cpu").score_pairs(QUERY, DOCS)
    model = transformers.AutoModelForSequenceClassification.from_pretrained(d).eval()
    tok = transformers.AutoTokenizer.from_pretrained(d)
    enc = tok([QUERY] * len(DOCS), DOCS, padding=True, return_tensors="pt")
    assert int(enc["token_type_ids"].max()) == 1
    ids, mask = enc["input_ids"], enc["attention_mask"]
    with torch.no_grad():
        segments = model(**enc).logits[:, -1].numpy()
        ones = model(input_ids=ids, attention_mask=mask, token_type_ids=torch.ones_like(ids)).logits[:, -1].numpy()
        zeros = model(input_ids=ids, attention_mask=mask).logits[:, -1].numpy()
    np.testing.assert_allclose(ones, got, atol=1e-5)
    assert np.abs(segments - got).max() > 1e-2 and np.abs(zeros - got).max() > 1e-2


def test_loaded_modules_and_unported_types(checkpoints, tmp_path):
    kinds = {name: type(load_encoder(dirs[0])).__name__ for name, dirs in checkpoints.items()}
    assert kinds == {"roberta": "RobertaModel", "xlm-roberta": "RobertaModel", "distilbert": "DistilBertModel",
                     "electra": "ElectraModel", "electra-factorized": "ElectraModel",
                     "distilbert-sinusoidal": "DistilBertModel", "albert": "AlbertModel",
                     "albert-groups": "AlbertModel", "roformer": "RoFormerModel",
                     "roformer-rotary-value": "RoFormerModel", "big_bird": "BigBirdModel",
                     "roberta-prelayernorm": "RobertaPreLayerNormModel"}
    assert load_encoder(checkpoints["roberta"][0]).pooler is None
    assert load_encoder(checkpoints["electra-factorized"][0]).embeddings_project is not None
    assert load_encoder(checkpoints["electra"][0]).embeddings_project is None
    # ALBERT's groups are shared: 3 layers run 2 group objects (0, 0, 1).
    groups = load_encoder(checkpoints["albert-groups"][0]).encoder.albert_layer_groups
    assert len(groups) == 2 and all(len(g.albert_layers) == 2 for g in groups)
    for model_type in ("bart", "mbart", "deberta-v2", "t5"):
        with pytest.raises(NotImplementedError, match=model_type):
            encoder_config({"model_type": model_type, "vocab_size": 10})
    for family, key in (("distilbert", "activation"), ("electra", "hidden_act"), ("roberta", "hidden_act"),
                        ("albert", "hidden_act"), ("big_bird", "hidden_act")):
        assert encoder_config({"model_type": family, key: "gelu_new"}) is not None
        with pytest.raises(NotImplementedError, match="'silu'"):
            encoder_config({"model_type": family, key: "silu"})


def test_roformer_refusals(checkpoints, tmp_path):
    """Flax RoFormer embeds at the hidden size with no ``embeddings_project``,
    so the reference cannot load a checkpoint whose ``embedding_size``
    differs; the port refuses it too.  A torch checkpoint's
    ``embed_positions.weight`` must be the sinusoid table the reference
    computes: one laid out otherwise (interleaved, as DistilBERT's) raises."""
    d = str(tmp_path / "emb16")
    write_family(d, "roformer", seed=3, embedding_size=16)
    with pytest.raises(ValueError, match="shape"):
        JaxSentenceEncoderRM(model=d, max_batch_size=4)
    with pytest.raises(NotImplementedError, match="embedding_size 16"):
        TorchSentenceEncoderRM(model=d, device="cpu")
    from lotus_tpu_torch.models.checkpoint import fit_state_dict, load_state_dict
    from lotus_tpu_torch.models.distilbert import sinusoidal_table
    from lotus_tpu_torch.models.roformer import sinusoidal_positions

    src = checkpoints["roformer"][0]
    state = load_state_dict(src)
    table = state["encoder.embed_positions.weight"]
    assert torch.equal(table, sinusoidal_positions(*table.shape))
    cfg = read_config(src)
    bad = {**state, "encoder.embed_positions.weight": sinusoidal_table(*table.shape)}
    with pytest.raises(ValueError, match="embed_positions"):
        fit_state_dict(new_module(cfg), bad)
