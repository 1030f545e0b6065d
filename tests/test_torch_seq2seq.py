"""Pegasus, Blenderbot and Blenderbot-Small in the port (``pegasus.py``,
``blenderbot.py``, ``blenderbot_small.py``), which the reference runs as
RMs only, and the encoder-decoder families' tokenizers, against the JAX
package's classes and ``AutoTokenizer`` on tiny checkpoints (width 32,
2 + 2 layers, 128 positions, weights of std 0.2):

- ``TorchSentenceEncoderRM(device="cpu")`` equals ``JaxSentenceEncoderRM``
  within 1e-5 for mean and CLS pooling, normalised and not, over a padded
  last batch (``""`` rows) and two sequence buckets;
- Blenderbot-Small's decoder normalises the token embeddings before it adds
  the positions (its encoder after): the reference equals the port and
  differs from the encoder's order in the decoder;
- Pegasus's sinusoid table: a torch checkpoint's ``embed_positions.weight``
  is held to the computed table, and a wrong one is refused;
- the checkpoint formats (``pytorch_model.bin`` without the tied
  embeddings, ``flax_model.msgpack``) give the same embeddings;
- a bucket past ``max_position_embeddings`` raises ``ValueError`` in both;
- the refusals: a reranker on an RM-only type raises ``ValueError`` as
  ``FlaxAutoModelForSequenceClassification`` does, and marian (whose
  tokenizer needs sentencepiece) raises ``NotImplementedError``;
- every family's tokenizer id for id against ``AutoTokenizer``, texts and
  pairs, cut to a ``max_length``: BART's byte-level BPE, Blenderbot's under
  both ``add_prefix_space`` settings, mBART's template set from
  ``src_lang`` at load time (not the file's) under two languages and
  mBART-50's, Pegasus's Unigram, and Blenderbot-Small's slow tokenizer,
  never read as byte-level BPE.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from torch_families import (  # noqa: E402
    CHARSMAP, SEQ2SEQ, mbart_tokenizer, seeded_texts, seeded_words, write_seq2seq, write_seq2seq_tokenizer,
)

from lotus_tpu.models import JaxSentenceEncoderRM  # noqa: E402
from lotus_tpu_torch.models import (  # noqa: E402
    BlenderbotSmallTokenizer, TorchCrossEncoderReranker, TorchSentenceEncoderRM, load_encoder,
    load_tokenizer,
)
from lotus_tpu_torch.models.bart import BartDecoder  # noqa: E402
from lotus_tpu_torch.models.charsmap import build_charsmap  # noqa: E402
from lotus_tpu_torch.models.torch_rm import bucketed_batches  # noqa: E402

RM_ONLY = ("pegasus", "blenderbot", "blenderbot-small")
DOCS = seeded_texts(5, 6, seeded_words(0, 200), 1, 6) + ["", " ".join(seeded_words(1, 14)), "Hello, WORLD! naïve ①"]
LONG = " ".join(seeded_words(2, 200))  # past 128 tokens in every tokenizer
TEXTS = seeded_texts(7, 40, seeded_words(0, 200), 0, 30) + [
    "", " ", "Hello, WORLD!", "don't stop (now)?", "it's  two\nlines\n\nand\ttabs", "a.b,c!d?e(f)g'h", "ＡＢ ① ㍿ ﬁne",
    "</s> inside </s>", "__end__ __null__ twice", "<mask> and <pad>", "MiXeD CaSe 😀 naïve"]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    out = {}
    for family in RM_ONLY:
        d = str(tmp_path_factory.mktemp(f"{family}-rm"))
        write_seq2seq(d, family, seed=3, init_std=0.2)
        out[family] = d
    return out


@pytest.mark.parametrize("family", RM_ONLY)
@pytest.mark.parametrize("pooling,normalize", [("mean", True), ("mean", False), ("cls", True), ("cls", False)])
def test_embeddings_equal_jax(checkpoints, family, pooling, normalize):
    d = checkpoints[family]
    kw = dict(max_batch_size=4, pooling=pooling, normalize_embeddings=normalize)
    want = JaxSentenceEncoderRM(model=d, **kw)._embed(DOCS)
    port = TorchSentenceEncoderRM(model=d, device="cpu", **kw)
    got = port._embed(DOCS)
    buckets = {ids.shape[1] for _, ids, _ in bucketed_batches(port.tokenizer, DOCS, None, 4, 512, "cpu")}
    assert len(buckets) >= 2 and got.shape == want.shape == (len(DOCS), 32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_blenderbot_small_decoder_norm_order(checkpoints):
    d = checkpoints["blenderbot-small"]
    want = JaxSentenceEncoderRM(model=d, max_batch_size=4)._embed(DOCS)
    port = TorchSentenceEncoderRM(model=d, max_batch_size=4, device="cpu")
    np.testing.assert_allclose(port._embed(DOCS), want, atol=1e-5, rtol=0)
    swapped = port.encoder.decoder
    swapped.embed = BartDecoder.embed.__get__(swapped)  # the encoder's order: norm after the positions
    assert float(np.abs(port._embed(DOCS) - want).max()) > 1e-3


def test_pegasus_table_is_checked(checkpoints, tmp_path):
    d = checkpoints["pegasus"]
    state = transformers.AutoModel.from_pretrained(d).state_dict()
    assert "encoder.embed_positions.weight" in state and "decoder.embed_positions.weight" in state
    want = TorchSentenceEncoderRM(model=d, max_batch_size=4, device="cpu")._embed(DOCS)
    for name, bump in (("as-saved", 0.0), ("wrong", 0.5)):
        path = str(tmp_path / name)
        shutil.copytree(d, path)
        os.remove(os.path.join(path, "model.safetensors"))
        torch.save({**state, "decoder.embed_positions.weight": state["decoder.embed_positions.weight"] + bump},
                   os.path.join(path, "pytorch_model.bin"))
        if bump:
            with pytest.raises(ValueError, match="decoder.embed_positions.weight .* is not the sinusoid table"):
                load_encoder(path)
        else:
            got = TorchSentenceEncoderRM(model=path, max_batch_size=4, device="cpu")._embed(DOCS)
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("family", RM_ONLY)
def test_checkpoint_formats(checkpoints, family, tmp_path):
    d = checkpoints[family]
    want = TorchSentenceEncoderRM(model=d, max_batch_size=4, device="cpu")._embed(DOCS)
    tied = ("encoder.embed_tokens.weight", "decoder.embed_tokens.weight")
    state = transformers.AutoModel.from_pretrained(d).state_dict()
    for name in ("bin", "flax"):
        path = str(tmp_path / name)
        shutil.copytree(d, path)
        os.remove(os.path.join(path, "model.safetensors"))
        if name == "bin":
            torch.save({k: v for k, v in state.items() if k not in tied}, os.path.join(path, "pytorch_model.bin"))
        else:
            transformers.FlaxAutoModel.from_pretrained(d, from_pt=True).save_pretrained(path)
        got = TorchSentenceEncoderRM(model=path, max_batch_size=4, device="cpu")._embed(DOCS)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=name)


@pytest.mark.parametrize("family", RM_ONLY)
def test_length_error_matches_reference(checkpoints, family):
    d = checkpoints[family]
    docs = ["short one", LONG]
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        JaxSentenceEncoderRM(model=d, max_batch_size=2, max_seq_length=256)._embed(docs)
    with pytest.raises(ValueError, match="256-token bucket is longer than max_position_embeddings 128"):
        TorchSentenceEncoderRM(model=d, max_batch_size=2, max_seq_length=256, device="cpu")._embed(docs)


@pytest.mark.parametrize("family", RM_ONLY)
def test_reranker_refused_on_rm_only_types(checkpoints, family):
    d = checkpoints[family]
    with pytest.raises(ValueError, match="Unrecognized configuration class"):
        transformers.FlaxAutoModelForSequenceClassification.from_pretrained(d, from_pt=True)
    with pytest.raises(ValueError, match=f"model_type '{family}' has no sequence classifier"):
        TorchCrossEncoderReranker(model=d, device="cpu")


def test_marian_is_refused(checkpoints, tmp_path):
    path = str(tmp_path / "marian")
    shutil.copytree(checkpoints["blenderbot"], path)
    with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
        cfg = json.load(f)
    with open(os.path.join(path, "config.json"), "w", encoding="utf-8") as f:
        json.dump({**cfg, "model_type": "marian"}, f)
    # The port runs marian now (test_torch_marian.py); Blenderbot's learned
    # position table is not the sinusoid table Marian computes: refused.
    with pytest.raises(ValueError, match="embed_positions.weight .* is not the sinusoid table .* Flax Marian"):
        TorchSentenceEncoderRM(model=path, device="cpu")


# ---- tokenizers --------------------------------------------------------------

TOKENIZER_CASES = {
    "bart": ("bart", {}),
    "blenderbot-prefix": ("blenderbot", {"add_prefix_space": True}),
    "blenderbot-no-prefix": ("blenderbot", {"add_prefix_space": False}),
    "mbart-ro": ("mbart", {"src_lang": "ro_RO"}),
    "mbart-default": ("mbart", {}),
    "pegasus": ("pegasus", {}),
    "blenderbot-small": ("blenderbot-small", {}),
}


@pytest.fixture(scope="module")
def tokenizer_dirs(tmp_path_factory):
    out = {}
    for name, (family, kw) in TOKENIZER_CASES.items():
        d = str(tmp_path_factory.mktemp(f"tok-{name}"))
        tok = write_seq2seq_tokenizer(d, family, 0, **kw)
        with open(os.path.join(d, "config.json"), "w", encoding="utf-8") as f:
            json.dump({"model_type": family}, f)
        if name == "mbart-default":
            # The file's template names de_DE; the config names no src_lang, so the class uses en_XX.
            tok.src_lang = "de_DE"
            tok.save_pretrained(d)
            path = os.path.join(d, "tokenizer_config.json")
            with open(path, encoding="utf-8") as f:
                cfg = json.load(f)
            cfg.pop("src_lang", None)
            with open(path, "w", encoding="utf-8") as f:
                json.dump(cfg, f)
        out[name] = d
    return out


@pytest.mark.parametrize("name", list(TOKENIZER_CASES))
def test_tokenizer_ids_match_auto_tokenizer(tokenizer_dirs, name):
    d = tokenizer_dirs[name]
    ref = transformers.AutoTokenizer.from_pretrained(d)
    port = load_tokenizer(d)
    assert isinstance(port, BlenderbotSmallTokenizer) == (name == "blenderbot-small")
    assert port.encode(TEXTS) == ref(TEXTS)["input_ids"]
    cut = ref(TEXTS, truncation=True, max_length=12)["input_ids"]
    assert port.encode(TEXTS, max_length=12) == cut
    if not name.startswith("blenderbot-"):  # Blenderbot's template has no pair (Blenderbot-Small: RM only)
        second = TEXTS[::-1]
        want = ref(TEXTS, second, truncation=True, max_length=24)["input_ids"]
        assert port.encode(TEXTS, second, max_length=24) == want
    ids, mask = port.pad(port.encode(TEXTS, max_length=40), 40)
    enc = ref(TEXTS, padding="max_length", truncation=True, max_length=40)
    np.testing.assert_array_equal(ids, enc["input_ids"])
    np.testing.assert_array_equal(mask, enc["attention_mask"])


def test_mbart_template_is_set_from_src_lang(tokenizer_dirs):
    ref = transformers.AutoTokenizer.from_pretrained(tokenizer_dirs["mbart-default"])
    with open(os.path.join(tokenizer_dirs["mbart-default"], "tokenizer.json"), encoding="utf-8") as f:
        assert "de_DE" in json.dumps(json.load(f)["post_processor"])
    ids = load_tokenizer(tokenizer_dirs["mbart-default"]).encode(["hello"], ["world"])[0]
    assert ids[-2:] == ref.convert_tokens_to_ids(["</s>", "en_XX"]) and ids.count(ref.eos_token_id) == 1
    ro = load_tokenizer(tokenizer_dirs["mbart-ro"]).encode(["hello"])[0]
    assert ro[-1] == ref.convert_tokens_to_ids("ro_RO")


def test_mbart50_template(tmp_path):
    d = str(tmp_path)
    transformers.MBart50TokenizerFast(tokenizer_object=mbart_tokenizer(0, build_charsmap(CHARSMAP)),
                                      src_lang="de_DE").save_pretrained(d)
    ref = transformers.AutoTokenizer.from_pretrained(d)
    port = load_tokenizer(d)
    assert port.encode(TEXTS) == ref(TEXTS)["input_ids"]
    assert port.encode(TEXTS, TEXTS[::-1], max_length=24) == ref(TEXTS, TEXTS[::-1], truncation=True,
                                                                  max_length=24)["input_ids"]


def test_blenderbot_small_class_named_or_not(tokenizer_dirs, tmp_path):
    """With ``tokenizer_config.json`` naming ``BlenderbotSmallTokenizer``
    (which sends ``AutoTokenizer`` to a fast class it cannot convert to)
    the port still reads the slow tokenizer, whose ids it gives; it never
    reads these files as byte-level BPE (``JsonTokenizer.from_vocab_merges``):
    its ids are ``@@``-continued pieces."""
    d = str(tmp_path / "named")
    shutil.copytree(tokenizer_dirs["blenderbot-small"], d)
    path = os.path.join(d, "tokenizer_config.json")
    with open(path, encoding="utf-8") as f:
        cfg = json.load(f)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({**cfg, "tokenizer_class": "BlenderbotSmallTokenizer"}, f)
    os.remove(os.path.join(d, "config.json"))
    slow = transformers.BlenderbotSmallTokenizer(os.path.join(d, "vocab.json"), os.path.join(d, "merges.txt"))
    port = load_tokenizer(d)
    assert isinstance(port, BlenderbotSmallTokenizer)
    assert port.encode(TEXTS) == [slow(t)["input_ids"] for t in TEXTS]
    names = {i: t for t, i in port.vocab.items()}
    pieces = {names[i] for row in port.encode(TEXTS) for i in row}
    assert any(p.endswith("@@") for p in pieces)


def test_every_family_has_a_tokenizer_case():
    assert {family for family, _ in TOKENIZER_CASES.values()} == set(SEQ2SEQ)
