"""BLOOM in the port (``bloom.py``), which the reference runs as an RM only,
and the regular expressions of its tokenizer (``oniguruma.py``), against
the JAX package's classes and the ``tokenizers`` library, on tiny
checkpoints (width 32, 2 layers, 4 heads, weights of std 0.2) saved with
``save_pretrained``, their tokenizers left-padded as BLOOM's
``tokenizer_config.json`` says:

- ``TorchSentenceEncoderRM(device="cpu")`` equals ``JaxSentenceEncoderRM``
  within 1e-5 in f32 for mean and CLS pooling, normalised and not, over a
  padded last batch and two sequence buckets; with both settings of
  ``apply_residual_connection_post_layernorm``; from ``flax_model.msgpack``,
  from ``.bin`` shards and from a ``BloomForCausalLM`` file (``transformer.``
  names);
- a head count that is not a power of two (6): the reference raises
  ``AttributeError`` there (transformers 4.57's Flax code calls
  ``jnp.cat``, which JAX 0.9 lacks); given ``jnp.concatenate`` under that
  name it runs the branch, and the port equals it within 1e-5;
- ALiBi's positions come from the mask, so a left-padded text embeds as it
  does alone; in bf16 the table is rounded as the reference rounds it (bit
  for bit against ``build_alibi_tensor`` at 16 heads), and the embeddings
  equal the reference's own bf16 run within 2.5e-3, closer than the same
  forward with the table left in f32;
- the tokenizer id for id against ``AutoTokenizer`` (``BloomTokenizerFast``,
  also with ``add_prefix_space``), and the translated ``Split`` and
  ``Replace`` patterns against the ``tokenizers`` library on text with
  ``()[]|``, BLOOM's punctuation, tabs, newlines, runs of spaces,
  U+001C-U+001F, U+0085, U+00A0, U+3000 and U+200B;
- ``n_embed`` / ``num_attention_heads`` / ``num_hidden_layers`` read as
  ``BloomConfig`` reads them; no pad token raises ``ValueError`` in both
  packages; a reranker is refused as the Flax auto class refuses it.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402
from tokenizers import Regex, normalizers, pre_tokenizers  # noqa: E402
from torch_families import BLOOM_SPLIT, seeded_texts, seeded_words, write_alibi_decoder  # noqa: E402

from lotus_tpu.models import JaxSentenceEncoderRM  # noqa: E402
from lotus_tpu_torch.models import (  # noqa: E402
    BloomConfig, TorchCrossEncoderReranker, TorchSentenceEncoderRM, load_encoder, load_state_dict, load_tokenizer,
)
from lotus_tpu_torch.models import bloom  # noqa: E402
from lotus_tpu_torch.models.oniguruma import translate  # noqa: E402
from lotus_tpu_torch.models.tokenizer_json import normalizer, pre_tokenizer  # noqa: E402
from lotus_tpu_torch.models.torch_rm import bucketed_batches  # noqa: E402

DOCS = seeded_texts(5, 6, seeded_words(0, 200), 1, 6) + ["", " ".join(seeded_words(1, 14)),
                                                           "Hello, WORLD! (naïve) [x]y|z ① 日本 😀 …。"]
# Text for the patterns: BLOOM's separators, brackets, every kind of space.
SPACES = "\t\n\x0b\x0c\r\x1c\x1d\x1e\x1f\x85\xa0   ​   　"
PATTERN_TEXTS = seeded_texts(9, 20, seeded_words(2, 100), 0, 12) + [
    "", " ", "   ", "a(b)c|d e", " [x]y", "(()) [[]] || a-b_c\\d", "hi, there! ok…。，、।۔،yes",
    "  two  spaces\t\ttab\n\nnl\r\n", "x\x1cy\x1dz\x1e\x1fw", " ".join(SPACES), SPACES, "a" + "b".join(SPACES) + "c",
    "word​joined​", "日本語。中文，、ok", "end.", "?!", "  (lead", "trail)  "]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("bloom"))
    write_alibi_decoder(d, "bloom", seed=3, init_range=0.2)
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


@pytest.mark.parametrize("post_layernorm", [True, False])
def test_residual_after_layernorm(tmp_path, post_layernorm):
    """``apply_residual_connection_post_layernorm`` takes the residuals from
    the LayerNorms' outputs: each setting equals the reference, and they
    differ."""
    d = str(tmp_path / "bloom")
    write_alibi_decoder(d, "bloom", seed=4, init_range=0.2,
                        apply_residual_connection_post_layernorm=post_layernorm)
    assert load_encoder(d).config.apply_residual_connection_post_layernorm is post_layernorm
    got = assert_equal_jax(d)
    other = str(tmp_path / "other")
    write_alibi_decoder(other, "bloom", seed=4, init_range=0.2,
                        apply_residual_connection_post_layernorm=not post_layernorm)
    assert np.abs(got - TorchSentenceEncoderRM(model=other, device="cpu", max_batch_size=4)._embed(DOCS)).max() > 1e-3


@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_non_power_of_two_heads(tmp_path, monkeypatch, pooling):
    """6 heads: the slopes of 4 heads and the odd powers of the next base.
    The reference fails on ``jnp.cat``; with it given, the port equals it."""
    d = str(tmp_path / "bloom6")
    write_alibi_decoder(d, "bloom", seed=5, init_range=0.2, hidden_size=48, n_head=6)
    with pytest.raises(AttributeError, match="cat"):
        JaxSentenceEncoderRM(model=d, max_batch_size=4)._embed(DOCS[:2])
    monkeypatch.setattr(jnp, "cat", jnp.concatenate, raising=False)
    assert_equal_jax(d, pooling=pooling)
    np.testing.assert_array_equal(bloom.alibi_slopes(6).numpy(), [2**-2, 2**-4, 2**-6, 2**-8, 2**-1, 2**-3])


def test_left_padding(checkpoint):
    """The tokenizer pads on the left, as ``tokenizer_config.json`` says:
    the ids and masks equal the reference's; ALiBi's positions start at
    each row's first real token, so a padded text embeds as it does alone."""
    ref = transformers.AutoTokenizer.from_pretrained(checkpoint)
    port = load_tokenizer(checkpoint)
    assert ref.padding_side == port.padding_side == "left"
    batch = DOCS[:4]
    (_, ids, mask), = bucketed_batches(port, batch, None, 4, 512, "cpu")
    want = ref(batch, padding="max_length", truncation=True, max_length=ids.shape[1], return_tensors="np")
    np.testing.assert_array_equal(ids.numpy(), want["input_ids"])
    np.testing.assert_array_equal(mask.numpy(), want["attention_mask"])
    assert (mask[:, 0] == 0).any() and (mask[:, -1] == 1).all()
    rm = TorchSentenceEncoderRM(model=checkpoint, device="cpu", max_batch_size=4)
    together = rm._embed(batch)
    alone = np.concatenate([rm._embed([t]) for t in batch])
    np.testing.assert_allclose(together, alone, atol=1e-6, rtol=0)


def test_bf16_alibi_rounding(tmp_path, monkeypatch):
    """At 16 heads the slopes are powers of 2^-0.5: the bf16 table rounds.
    The port's table equals ``build_alibi_tensor``'s bit for bit on the
    left-padded batches, and its bf16 embeddings of ~300-token texts equal
    the reference's bf16 run within 2.5e-3 (bf16's rounding elsewhere),
    closer than with the table kept in f32."""
    from transformers.models.bloom.modeling_flax_bloom import build_alibi_tensor

    d = str(tmp_path / "bloom16")
    write_alibi_decoder(d, "bloom", seed=6, init_range=0.2, hidden_size=64, n_head=16)
    docs = seeded_texts(5, 8, seeded_words(0, 200), 100, 200)
    for _, _, mask in bucketed_batches(load_tokenizer(d), docs, None, 4, 512, "cpu"):
        want = np.asarray(build_alibi_tensor(jnp.asarray(mask.numpy()), 16, jnp.bfloat16).astype(jnp.float32))
        got = bloom.build_alibi(mask, 16, torch.bfloat16)
        np.testing.assert_array_equal(got.float().numpy(), want)
        assert not torch.equal(got.float(), bloom.build_alibi(mask, 16, torch.float32))
    want = JaxSentenceEncoderRM(model=d, max_batch_size=4, dtype=jnp.bfloat16)._embed(docs)
    got = TorchSentenceEncoderRM(model=d, device="cpu", max_batch_size=4, dtype=torch.bfloat16)._embed(docs)
    err = float(np.abs(got - want).max())
    build = bloom.build_alibi
    monkeypatch.setattr(bloom, "build_alibi", lambda mask, heads, dtype: build(mask, heads, torch.float32))
    unrounded = TorchSentenceEncoderRM(model=d, device="cpu", max_batch_size=4, dtype=torch.bfloat16)._embed(docs)
    assert got.dtype == np.float32 and err <= 2.5e-3
    assert err < 0.75 * float(np.abs(unrounded - want).max())


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
    which it refuses) and a ``BloomForCausalLM`` file (``transformer.``
    names beside ``lm_head``) load to the base model's parameters."""
    d = str(tmp_path / layout)
    if layout == "causal-lm":
        write_alibi_decoder(d, "bloom", seed=3, init_range=0.2, causal_lm=True)
        assert all(k.startswith(("transformer.", "lm_head.")) for k in load_state_dict(d))
        assert_equal_jax(d)
        want = {k.removeprefix("transformer."): t for k, t in load_state_dict(d).items() if k != "lm_head.weight"}
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
    """BLOOM-7b1's ``config.json`` names the width ``n_embed`` and the heads
    ``num_attention_heads``; ``BloomConfig`` reads them over its own names."""
    raw = {"model_type": "bloom", "n_embed": 64, "num_attention_heads": 8, "n_head": 2, "num_hidden_layers": 3,
           "vocab_size": 100, "apply_residual_connection_post_layernorm": True}
    ref = transformers.BloomConfig(**{k: v for k, v in raw.items() if k != "model_type"})
    cfg = BloomConfig.from_dict(raw)
    assert (cfg.hidden_size, cfg.n_head, cfg.n_layer) == (ref.hidden_size, ref.n_head, ref.n_layer) == (64, 8, 3)
    assert cfg.apply_residual_connection_post_layernorm


@pytest.mark.parametrize("add_prefix_space", [None, True])
def test_tokenizer_ids_match_auto_tokenizer(tmp_path, add_prefix_space):
    d = str(tmp_path / "tok")
    kw = {} if add_prefix_space is None else {"add_prefix_space": add_prefix_space}
    write_alibi_decoder(d, "bloom", seed=3, tokenizer_kw=kw, n_layer=1)
    ref = transformers.AutoTokenizer.from_pretrained(d)
    port = load_tokenizer(d)
    texts = PATTERN_TEXTS + DOCS
    assert port.encode(texts) == ref(texts)["input_ids"]
    assert port.encode(texts, max_length=12) == ref(texts, truncation=True, max_length=12)["input_ids"]
    second = texts[::-1]
    assert port.encode(texts, second, max_length=24) == ref(texts, second, truncation=True, max_length=24)["input_ids"]
    ids, mask = port.pad(port.encode(texts, max_length=40), 40)
    enc = ref(texts, padding="max_length", truncation=True, max_length=40)
    np.testing.assert_array_equal(ids, enc["input_ids"])
    np.testing.assert_array_equal(mask, enc["attention_mask"])


@pytest.mark.parametrize("pattern", [BLOOM_SPLIT, r"\s+", r"\S+", r"(?:ab|c)+", r" ?[^\s.,]+|[.,]", r"x{2,}|y{1,2}?",
                                     r"[\-\]\[()|]+", r"\x{3000}| | ", r"a.b", r"\s+(?!\S)"])
def test_split_regex_matches_tokenizers(pattern):
    """``Split`` on a ``Regex``, isolated, cuts as the library does."""
    ours = pre_tokenizer({"type": "Split", "pattern": {"Regex": pattern}, "behavior": "Isolated", "invert": False})
    lib = pre_tokenizers.Split(Regex(pattern), "isolated", invert=False)
    for t in PATTERN_TEXTS:
        assert [w for w, _ in ours((t, True))] == [w for w, _ in lib.pre_tokenize_str(t)], (pattern, t)


def test_bloom_pattern_translation():
    """The nested class is flattened: brackets stay in words, ``(``, ``)``,
    ``|`` and White_Space (not U+001C-U+001F, not U+200B) split."""
    ours = pre_tokenizer({"type": "Split", "pattern": {"Regex": BLOOM_SPLIT}, "behavior": "Isolated"})
    assert [w for w, _ in ours((" [x]y", True))] == [" [x]y"]
    assert [w for w, _ in ours(("a(b)c|d", True))] == ["a", "(", "b", ")", "c", "|", "d"]
    assert [w for w, _ in ours(("x\x1cy​z", True))] == ["x\x1cy​z"]
    assert translate(BLOOM_SPLIT).count("[") == 1  # one class, the nested one flattened into it


@pytest.mark.parametrize("pattern", [r"\s", r" {2,}", r"[\s]+"])
def test_replace_regex_matches_tokenizers(pattern):
    """``Replace`` on a ``Regex`` goes through the translator: ``\\s`` leaves
    U+001C as the library does (Python's own ``\\s`` would replace it)."""
    ours = normalizer({"type": "Replace", "pattern": {"Regex": pattern}, "content": "_"})
    lib = normalizers.Replace(Regex(pattern), "_")
    for t in PATTERN_TEXTS:
        assert ours(t) == lib.normalize_str(t), (pattern, t)
    assert ours("a\x1cb") == "a\x1cb"


@pytest.mark.parametrize("pattern,construct", [(r"\d+", r"\d"), (r"\w+", r"\w"), (r"\p{L}+", r"\p"), ("^a", "anchor"),
                                               ("(?<=a)b", "group"), (r"a*", "empty string"), (r"[^[^a]]", "negated"),
                                               (r"a++", "possessive"), (r"[\S]", r"\S inside"), ("(a", "unclosed")])
def test_untranslated_constructs_are_refused(pattern, construct):
    with pytest.raises(NotImplementedError, match=construct.replace("\\", "\\\\")):
        translate(pattern)


@pytest.mark.parametrize("behavior,invert", [("removed", False), ("isolated", True), ("merged_with_next", False)])
def test_other_regex_splits_are_refused(behavior, invert):
    spec = json.loads(pre_tokenizers.Split(Regex(BLOOM_SPLIT), behavior, invert=invert).__getstate__())
    with pytest.raises(NotImplementedError, match="Split"):
        pre_tokenizer(spec)


def test_missing_pad_token_raises(tmp_path):
    d = str(tmp_path / "bloom")
    write_alibi_decoder(d, "bloom", seed=3, tokenizer_kw={"pad": None}, n_layer=1)
    with pytest.raises(ValueError, match="padding"):
        JaxSentenceEncoderRM(model=d, max_batch_size=2)._embed(DOCS[:2])
    with pytest.raises(ValueError, match="no padding token"):
        TorchSentenceEncoderRM(model=d, max_batch_size=2, device="cpu")._embed(DOCS[:2])


def test_reranker_refused(checkpoint):
    with pytest.raises(ValueError, match="Unrecognized configuration class"):
        transformers.FlaxAutoModelForSequenceClassification.from_pretrained(checkpoint, from_pt=True)
    with pytest.raises(ValueError, match="model_type 'bloom' has no sequence classifier"):
        TorchCrossEncoderReranker(model=checkpoint, device="cpu")
