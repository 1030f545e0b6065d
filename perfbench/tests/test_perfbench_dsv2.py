"""The DeepSeek-V2 cell (``dsv2_lite.passage_join``) rehearsed end to end on
the CPU at a tiny size (f32, 3 layers, 8 experts); two faults planted in its
timed path and its control, each of which has to come out not correct; the
plain BPE encoder against the program's tokenizer; the arithmetic of its
bounds."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from perfbench import bounds_moe, bpe_files, control_dsv2, harness, run, texts
from perfbench.reference.bpe import ByteBPE

NAME = "dsv2_lite.passage_join"
SEED = 2**31 + 4321
TINY = dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4, intermediate_size=96, moe_intermediate_size=32,
            n_routed_experts=8, num_experts_per_tok=2, kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16,
            v_head_dim=32, vocab_size=2000)
NEW_METRICS = {"passage_join.mfu", "moe.experts_roofline_pct", "moe.route_ms", "mla.attn_ms", "moe.load_max_ratio",
               "device.idle_pct.passage_join"}


def tiny() -> tuple[dict, dict]:
    """The cell and its configuration cut to a CPU's size, in f32; the
    limits are the configuration's own."""
    _, cell, cfg = harness.cell_files(NAME)
    cell, cfg = json.loads(json.dumps(cell)), json.loads(json.dumps(cfg))
    cfg.update(TINY, right_docs=1024, words=[20, 40], store=dict(cfg["store"], nlist=2), dtype="float32")
    cell["traffic"].update(batch=64, pool_requests=4, judged_requests=2, judge_docs=16)
    cell.update(trace_start_s=0.3, trace_s=0.6)
    return cell, cfg


def rehearse(trace: bool = False, seconds: float = 1.0):
    cell, cfg = tiny()
    return run.run_cell(NAME, SEED, seconds, trace, device="cpu", cell=cell, config=cfg)


@pytest.mark.parametrize("trace", [False, True])
def test_cell_rehearsed_on_cpu(trace):
    result, checks = rehearse(trace, seconds=3.0 if trace else 1.0)
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["correct"], checks
    if trace:
        assert set(result["metrics"]) == NEW_METRICS, result["metrics"]
        assert 1.0 <= result["metrics"]["moe.load_max_ratio"]["value"] <= TINY["n_routed_experts"]
    else:
        assert set(result["metrics"]) == {"search_qps", "setup_s"}
    assert all(np.isfinite(m["value"]) for m in result["metrics"].values())


def _move_ids(monkeypatch):
    """Each answer's first id moved half the store away, where the store
    answers."""
    from lotus_tpu_torch import TorchVS
    from lotus_tpu_torch.types import RMOutput

    call = TorchVS.__call__

    def wrong(self, q, k, ids=None, **kw):
        out = call(self, q, k, ids=ids, **kw)
        i = np.array(out.indices)
        i[:, 0] = (i[:, 0] + 512) % 1024
        return RMOutput(distances=out.distances, indices=i.tolist())

    monkeypatch.setattr(TorchVS, "__call__", wrong)


def _skip_shared_in_window(monkeypatch):
    """The shared experts dropped from the model once set-up is over."""
    cell = harness.adapter("passage_join").Cell
    window = cell.window

    def without_shared(self, seconds):
        for m in self.store.rm.encoder.modules():
            if hasattr(m, "shared_experts"):
                del m.shared_experts
        return window(self, seconds)

    monkeypatch.setattr(cell, "window", without_shared)


@pytest.mark.parametrize("fault", [_move_ids, _skip_shared_in_window], ids=["id_moved", "shared_skipped"])
def test_broken_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result, checks = rehearse()
    assert not result["correct"], checks


def test_control_is_not_correct():
    """The fp8 control at the published widths over three layers (one dense,
    two MoE) and a few short passages: its error grows with width and depth,
    so the tiny model would hide it."""
    cell, cfg = tiny()
    _, _, full = harness.cell_files(NAME)
    cfg.update({k: full[k] for k in TINY}, num_hidden_layers=3, vocab_size=full["vocab_size"], right_docs=64,
               dtype="bfloat16")
    cell["traffic"].update(batch=8, judged_requests=1, judge_docs=6)
    checks = control_dsv2.control_checks(cell, cfg, SEED, torch.device("cpu"))
    assert not all(c["ok"] for c in checks), checks


def test_plain_bpe_is_the_programs_tokenizer(tmp_path):
    from lotus_tpu_torch.models.auto import load_tokenizer

    vocab = texts.make_vocab(5, 4000)
    spec = bpe_files.bpe_spec([w for w in vocab if w.isalpha()], 6000)
    bpe_files.write_tokenizer_dir(str(tmp_path), spec, {"model_type": "deepseek_v2"})
    tok = load_tokenizer(str(tmp_path))
    docs = texts.synth_texts(vocab, 64, 5, 60, 3, 4) + ["", "Two  spaces, digits 123 and it's; (odd) punctuation!"]
    plain = ByteBPE(spec, bpe_files.BOS)
    for length in (16, 512):
        assert tok.encode(docs, max_length=length) == [plain.encode(d, length) for d in docs]
    ids, mask = tok.pad(tok.encode(docs[:2], max_length=512), 512)
    assert ids[0, 0] == 5998 and (ids[mask == 0] == 5999).all() and (mask[:, 0] == 1).all()


def test_bounds_of_deepseek_v2_lite():
    """2.2417 B parameters a token (the gate, 6 of 64 experts and 2 shared in
    26 MoE layers, one dense layer, MLA in 27), 10,240 operations a scored
    pair a layer, and a published-width expert layer call bound by its
    operations."""
    _, _, cfg = harness.cell_files(NAME)
    assert bounds_moe.weights_per_token(cfg) == 2_241_719_808
    assert bounds_moe.pair_flops(cfg) == 10_240
    least = bounds_moe.experts_least_s(cfg, 64 * 512 * 6, 64)
    assert least["by"] == "operations" and abs(least["s"] - 196608 * 2 * 3 * 2048 * 1408 / 989e12) < 1e-12
