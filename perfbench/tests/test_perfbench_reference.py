"""The plain references at tiny sizes, held to brute force and to the
program on the CPU, and the frozen copies held to their originals."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

from perfbench import bounds, corpus, texts
from perfbench.reference import judge
from perfbench.reference.bert import PlainBert
from perfbench.reference.topk import RunningTopK, int4_rows
from perfbench.reference.wordpiece import WordPiece

TINY = dict(vocab_size=3000, hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=512, type_vocab_size=2, layer_norm_eps=1e-12, hidden_act="gelu",
            model_type="bert")


def test_running_topk_is_exact():
    g = torch.Generator().manual_seed(0)
    q, x = torch.randn(37, 16, generator=g), torch.randn(1000, 16, generator=g)
    acc = RunningTopK(q, 7, q_block=8)
    for lo in range(0, 1000, 300):
        acc.add(lo, x[lo : lo + 300])
    s, i = torch.topk(q @ x.T, 7, dim=1)
    assert torch.equal(acc.ids, i) and torch.allclose(acc.scores, s)


def test_int4_rows_take_seven_levels_a_side():
    x = torch.randn(5, 32)
    y = int4_rows(x)
    steps = y / (x.abs().amax(1, keepdim=True) / 7)
    assert torch.allclose(steps, steps.round(), atol=1e-4) and steps.abs().max() <= 7 + 1e-4


def test_corpus_is_the_programs():
    from lotus_tpu_torch.ops import bench_data

    seed = 2**31 + 77
    c = corpus.corpus_centers(seed, 64, 32, torch.device("cpu"))
    assert torch.equal(c, bench_data.corpus_centers(seed, 64, 32, torch.device("cpu")))
    assert torch.equal(corpus.gen_chunk(seed, 3, c, 100, 2.5), bench_data.gen_chunk(seed, 3, c, 100, 2.5))


def test_texts_are_chip_smokes():
    import importlib.util

    from perfbench import harness

    spec = importlib.util.spec_from_file_location("chip_smoke_copy_check", harness.ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert texts.make_vocab(5, 2000) == cs.smoke_vocab(5, 2000)
    vocab = texts.make_vocab(5, 2000)
    assert texts.synth_texts(vocab, 500, 8, 48, 9, 5) == cs.synth_texts(vocab, 500, 8, 48, 9, per_topic=5)


def test_wordpiece_is_bert_tokenizers():
    from lotus_tpu_torch.models.tokenizer_json import JsonTokenizer

    vocab = texts.make_vocab(3, 3000)
    docs = texts.synth_texts(vocab, 200, 8, 48, 4, 5) + ["Héllo, wörld!! It's 3.5%", "a\tb\nc  (x) [y]", "zzzzqqq"]
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "vocab.txt"), "w") as f:
            f.write("\n".join(vocab) + "\n")
        with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
            f.write('{"do_lower_case": true}')
        tok = JsonTokenizer.from_vocab_txt(d)
        program = tok.encode(docs, None, max_length=512)
    wp = WordPiece(vocab)
    assert [list(p) for p in program] == [wp.encode(t) for t in docs]


def _model_dir(tmp_path, seed: int = 3):
    vocab = texts.make_vocab(seed, TINY["vocab_size"])
    w = texts.bert_weights(TINY, seed, torch.device("cpu"), torch.float32)
    texts.write_model_dir(str(tmp_path / "m"), TINY, vocab, w)
    return vocab, w


def test_plain_bert_is_the_programs(tmp_path):
    from lotus_tpu_torch.models import TorchSentenceEncoderRM

    vocab, w = _model_dir(tmp_path)
    docs = texts.synth_texts(vocab, 100, 8, 48, 6, 5)
    rm = TorchSentenceEncoderRM(model=str(tmp_path / "m"), max_batch_size=16, device="cpu")
    wp = WordPiece(vocab)
    ref = PlainBert(TINY, w, torch.device("cpu")).embed([wp.encode(t) for t in docs])
    ctl = PlainBert(TINY, w, torch.device("cpu"), fp8=True).embed([wp.encode(t) for t in docs])
    got = rm(docs)
    assert judge.emb_gap(got, ref) < 1e-5
    assert judge.emb_gap(ctl, ref) > 10 * judge.emb_gap(got, ref)


def test_bert_weights_and_file_round_trip(tmp_path):
    from lotus_tpu_torch.models.checkpoint import read_safetensors

    w = texts.bert_weights(TINY, 11, torch.device("cpu"), torch.bfloat16)
    texts.write_safetensors(str(tmp_path / "w.safetensors"), w)
    back = read_safetensors(str(tmp_path / "w.safetensors"))
    assert all(torch.equal(back[k], w[k]) for k in w)
    assert abs(float(w["encoder.layer.0.attention.self.query.weight"].float().std()) - 0.02) < 2e-3


def test_judge_numbers():
    ids = np.array([[0, 1], [2, 3]])
    assert judge.recall(ids, np.array([[1, 0], [2, 4]])) == 0.75
    assert judge.score_err(ids, np.ones((2, 2)), np.ones((2, 2)) * 0.5) == 0.5
    assert judge.score_err(np.array([[-1, 1]]), np.ones((1, 2)), np.ones((1, 2))) == float("inf")
    left = np.eye(3, dtype=np.float32)[:1]
    right = np.array([[1, 0, 0], [0.5, 0.5, 0], [0, 1, 0]], dtype=np.float32)
    assert judge.join_gap(np.array([[0, 1]]), np.array([[1.0, 0.5]]), left, right) == 0.0
    assert judge.join_gap(np.array([[0, 2]]), np.array([[1.0, 0.0]]), left, right) == pytest.approx(0.5)
    assert judge.join_gap(np.array([[0, 1]]), np.array([[1.0, 0.6]]), left, right) == pytest.approx(0.1)


def test_bounds_are_chip_smokes():
    from lotus_tpu_torch.ops import ivf_probe

    assert bounds.QU == ivf_probe.QU and bounds.NBK == ivf_probe.NBK
    w = texts.bert_weights(TINY, 1, torch.device("cpu"), torch.float32)
    params = sum(t.numel() for n, t in w.items() if not n.startswith(("embeddings.", "pooler.")))
    assert bounds.bert_weights_per_token(TINY) == params
