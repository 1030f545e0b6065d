"""Tiny BERT checkpoint directories for the port's model tests, written
with ``transformers`` (offline: vocabulary, config and weights are made
here, as ``tests/test_flax_rm.py`` makes its own), and the port's
checkpoint reader (``lotus_tpu_torch/models/checkpoint.py``) against
``transformers``: ``model.safetensors`` (f32, f16, bf16) and
``pytorch_model.bin`` load the tensors ``transformers`` loads, by name with
or without ``bert.``; a malformed msgpack and an unported ``model_type``
raise."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from lotus_tpu_torch.models import BertConfig, BertForSequenceClassification, BertModel, load_encoder, load_state_dict
from lotus_tpu_torch.models.checkpoint import fit_state_dict

transformers = pytest.importorskip("transformers")

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
         "the", "cat", "sat", "on", "mat", "dog", "##s", "hello", "world", "a"]


def seeded_vocab(seed: int, n_words: int = 400, n_pieces: int = 120) -> list[str]:
    """The special tokens, punctuation, CJK characters, seeded whole words
    (some accented) and ``##`` pieces."""
    rng = np.random.default_rng(seed)
    letters = list("abcdefghijklmnopqrstuvwxyz") + ["é", "ü", "σ"]

    def word(lo, hi):
        return "".join(rng.choice(letters, rng.integers(lo, hi + 1)))

    words = [word(1, 7) for _ in range(n_words)]
    pieces = ["##" + word(1, 3) for _ in range(n_pieces)]
    base = [*VOCAB[:5], *"!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~", "¿", "«", "»", "日", "本", "語", "ς"]
    return list(dict.fromkeys(base + VOCAB[5:] + words + pieces))


def write_bert(path: str, vocab: list[str] = VOCAB, *, num_labels: int | None = None, seed: int = 0,
               init_range: float = 0.02, max_position_embeddings: int = 64, **tok_kw):
    """A BERT checkpoint (hidden 32, 2 layers, 2 heads) in ``path``: a
    ``BertModel``, or with ``num_labels`` a ``BertForSequenceClassification``;
    ``init_range`` is the weights' standard deviation.  Returns the torch
    model."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    transformers.BertTokenizerFast(vocab_file=os.path.join(path, "vocab.txt"), **tok_kw).save_pretrained(path)
    cfg = transformers.BertConfig(
        vocab_size=len(vocab), hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, max_position_embeddings=max_position_embeddings, initializer_range=init_range,
        **({} if num_labels is None else {"num_labels": num_labels}),
    )
    torch.manual_seed(seed)
    model = (transformers.BertModel(cfg) if num_labels is None
             else transformers.BertForSequenceClassification(cfg)).eval()
    model.save_pretrained(path)
    return model


def sample_ids(seed, b=3, s=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, len(VOCAB), (b, s))
    mask = np.ones((b, s), np.int64)
    mask[1, 7:] = 0
    mask[2, 3:] = 0
    return ids, mask


@pytest.mark.parametrize("fmt", ["f32", "f16", "bf16", "bin"])
@pytest.mark.parametrize("num_labels", [None, 2])
def test_reader_loads_what_transformers_loads(tmp_path, fmt, num_labels):
    model = write_bert(str(tmp_path / "w"), num_labels=num_labels, seed=3)
    if fmt in ("f16", "bf16"):
        model = model.to(getattr(torch, {"f16": "float16", "bf16": "bfloat16"}[fmt]))
    d = str(tmp_path / fmt)
    model.save_pretrained(d, safe_serialization=fmt != "bin")
    want = type(model).from_pretrained(d, torch_dtype=model.dtype).state_dict()
    got = load_state_dict(d)
    assert set(got) <= set(want) and {k for k in want if "position_ids" not in k} <= set(got)
    for k, t in got.items():
        assert t.dtype == want[k].dtype and torch.equal(t, want[k]), k
    port = load_encoder(d, classifier=num_labels is not None)
    ids, mask = map(torch.from_numpy, sample_ids(0))
    with torch.no_grad():
        ref = model.float()(input_ids=ids, attention_mask=mask, token_type_ids=torch.zeros_like(ids))
        out = port(ids, mask)
    np.testing.assert_allclose(out.numpy(), (ref.logits if num_labels else ref.last_hidden_state).numpy(),
                               atol=1e-5)


def test_encoder_loads_a_classification_checkpoint_and_back(tmp_path):
    """A checkpoint's weights load by name with or without ``bert.``."""
    write_bert(str(tmp_path / "cls"), num_labels=1)
    enc = load_encoder(str(tmp_path / "cls"))
    assert isinstance(enc, BertModel) and enc.pooler is None
    bare = {k[len("bert."):]: v for k, v in load_state_dict(str(tmp_path / "cls")).items() if k.startswith("bert.")}
    cfg = BertConfig.from_dir(str(tmp_path / "cls"))
    with pytest.raises(KeyError, match="classifier"):
        fit_state_dict(BertForSequenceClassification(cfg), bare)
    fit_state_dict(BertModel(cfg), bare)


def test_msgpack_only_and_other_model_types_raise(tmp_path):
    """A malformed ``flax_model.msgpack`` raises ``ValueError`` naming the
    file; the model types the port does not run raise
    ``NotImplementedError`` naming the type, through ``config.json`` and
    through ``BertConfig`` (which reads ``bert`` alone); so does an
    activation outside the table (``gelu`` and ``gelu_new``)."""
    cfg_path = tmp_path / "cfg"
    write_bert(str(cfg_path))
    cfg = json.loads((cfg_path / "config.json").read_text())
    d = tmp_path / "flax"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(cfg))
    for blob in (b"\x80", b"\xc1", b"\x81\xa1a\xc7\x05\x01", b""):
        (d / "flax_model.msgpack").write_bytes(blob)
        with pytest.raises(ValueError, match="flax_model.msgpack"):
            load_state_dict(str(d))
    with pytest.raises(FileNotFoundError):
        load_encoder(str(tmp_path / "absent"))
    for model_type in ("bart", "mbart", "t5", "deberta-v2"):
        (cfg_path / "config.json").write_text(json.dumps({**cfg, "model_type": model_type}))
        with pytest.raises(NotImplementedError, match=model_type):
            load_encoder(str(cfg_path))
    for model_type in ("albert", "roformer", "big_bird", "roberta-prelayernorm", "deberta-v2"):
        with pytest.raises(NotImplementedError, match=model_type):
            BertConfig.from_dict({"model_type": model_type, "vocab_size": 10})
    with pytest.raises(NotImplementedError, match="silu"):
        BertConfig.from_dict({"model_type": "bert", "vocab_size": 10, "hidden_act": "silu"})
    assert BertConfig.from_dict({"model_type": "bert", "vocab_size": 10, "hidden_act": "gelu_new"}).hidden_act == "gelu_new"
