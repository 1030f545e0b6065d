"""The DeepSeek-V3.2 cell (``dsv32_exp.doc32k_join``) rehearsed end to end
on the CPU at a tiny size (f32, 1 dense and 2 MoE layers, an indexer
keeping 16 keys a query at 150-256 tokens, 8 of 16 experts in 4 groups
held), with its traced readers; faults planted in its timed path and its
control, each of which has to come out not correct; the arithmetic of its
bounds."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from perfbench import bounds_dsa, bounds_moe, control_dsv32, harness, run

NAME = "dsv32_exp.doc32k_join"
SEED = 2**31 + 2626
TINY = dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4, intermediate_size=96, moe_intermediate_size=32,
            n_routed_experts=8, router_experts=16, num_experts_per_tok=4, n_group=4, topk_group=2, q_lora_rank=32,
            kv_lora_rank=16, qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32, index_n_heads=16,
            index_head_dim=32, index_topk=16, first_k_dense_replace=1, vocab_size=2000)
NEW_METRICS = {"dsa.index_roofline_pct", "dsa.attn_roofline_pct", "doc32k_join.mfu", "device.idle_pct.doc32k_join"}


def tiny() -> tuple[dict, dict]:
    """The cell and its configuration cut to a CPU's size, in f32, with
    texts of 150-256 tokens; the limits are the configuration's own."""
    _, cell, cfg = harness.cell_files(NAME)
    cell, cfg = json.loads(json.dumps(cell)), json.loads(json.dumps(cfg))
    cfg.update(TINY, words=[70, 110], max_seq_length=256, dtype="float32")
    cell["traffic"].update(pool_requests=3, probe_rows=32, probe_span=[16, 140])
    cell.update(trace_start_s=0.3, trace_s=0.6)
    return cell, cfg


def rehearse(trace: bool = False, seconds: float = 1.0):
    cell, cfg = tiny()
    return run.run_cell(NAME, SEED, seconds, trace, device="cpu", cell=cell, config=cfg)


def _by_name(checks: list[dict]) -> dict:
    return {c["name"]: c for c in checks}


@pytest.mark.parametrize("trace", [False, True])
def test_cell_rehearsed_on_cpu(trace):
    result, checks = rehearse(trace, seconds=3.0 if trace else 1.0)
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["correct"], checks
    assert _by_name(checks)["index_agree"]["value"] == 1.0
    if trace:
        assert set(result["metrics"]) == NEW_METRICS, result["metrics"]
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
        i[:, 0] = (i[:, 0] + 16) % 32
        return RMOutput(distances=out.distances, indices=i.tolist())

    monkeypatch.setattr(TorchVS, "__call__", wrong)


def _in_window(monkeypatch, name, fault):
    """``fault`` in the place of ``dsa.<name>`` once set-up is over."""
    from lotus_tpu_torch.ops import dsa

    cell = harness.adapter("doc_join").Cell
    window = cell.window

    def faulty(self, seconds):
        monkeypatch.setattr(dsa, name, fault)
        return window(self, seconds)

    monkeypatch.setattr(cell, "window", faulty)


def _all_earlier_keys(monkeypatch):
    """Attention over every earlier key: the selection ignored."""
    from lotus_tpu_torch.ops import dsa

    topk = dsa.index_topk
    _in_window(monkeypatch, "index_topk", lambda q, k, w, _: topk(q, k, w, q.shape[1]))


def _relu_dropped(monkeypatch):
    from lotus_tpu_torch.ops import dsa

    def scores(q, k, w):
        m, heads, d = q.shape
        return torch.bmm(w[:, None], dsa.f32_matmul(q.reshape(m * heads, d), k.T).view(m, heads, -1)).squeeze(1)

    _in_window(monkeypatch, "index_scores", scores)


def _constant_head_weights(monkeypatch):
    from lotus_tpu_torch.ops import dsa

    scores = dsa.index_scores
    _in_window(monkeypatch, "index_scores", lambda q, k, w: scores(q, k, torch.ones_like(w)))


@pytest.mark.parametrize("fault", [_move_ids, _all_earlier_keys, _relu_dropped, _constant_head_weights],
                         ids=["id_moved", "all_earlier_keys", "relu_dropped", "constant_head_weights"])
def test_broken_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result, checks = rehearse()
    assert not result["correct"], checks


def test_control_is_not_correct():
    """The fp8 control at the tiny size in bf16: its roundings move the
    index scores past each other and the attention with them."""
    cell, cfg = tiny()
    cfg["dtype"] = "bfloat16"
    checks = control_dsv32.control_checks(cell, cfg, SEED, torch.device("cpu"))
    assert not all(c["ok"] for c in checks), checks


def test_bounds_of_deepseek_v32():
    """3.0822 B parameters a token (layers 0-7 at published widths: the
    query LoRA, MLA, the indexer, 3 dense MLPs, 5 MoE layers with the gate,
    the shared expert and 8 x 8 / 256 routed experts), 16,384 operations a
    scored pair in the indexer and 81,920 a selected pair in attention, a
    layer; both stages bound by their operations at the cell's shape."""
    _, _, cfg = harness.cell_files(NAME)
    assert round(bounds_dsa.weights_per_token(cfg) / 1e9, 4) == 3.0822
    assert bounds_dsa.index_pair_flops(cfg) == 16_384 and bounds_dsa.attn_pair_flops(cfg) == 81_920
    s, k = 32768, 2048
    scored, selected = s * (s + 1) / 2, k * (k + 1) / 2 + (s - k) * k
    index = bounds_dsa.index_least_s(cfg, scored, s, selected)
    attn = bounds_dsa.attn_least_s(cfg, selected, s)
    assert index["by"] == attn["by"] == "operations"
    assert abs(index["s"] - 16_384 * scored / 989e12) < 1e-15 and abs(attn["s"] - 81_920 * selected / 989e12) < 1e-15
    want = 2 * bounds_dsa.weights_per_token(cfg) * s + 8 * (16_384 * scored + 81_920 * selected)
    assert abs(bounds_dsa.dsv32_flops(cfg, s, scored, selected) - want) < 1
    assert bounds_moe.expert_params(cfg) == 3 * 7168 * 2048
