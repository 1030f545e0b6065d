"""The Kimi-Linear cell (``kimi_linear.long_join``) rehearsed end to end on
the CPU at a tiny size (f32, one period of 3 KDA and 1 latent attention
layer, 4 of 8 experts held), with its traced readers; faults planted in its
timed path and its control, each of which has to come out not correct; the
arithmetic of its bounds."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from perfbench import bounds_kda, control_kimi, harness, run

NAME = "kimi_linear.long_join"
SEED = 2**31 + 2424
TINY = dict(hidden_size=64, num_hidden_layers=4, num_attention_heads=4, intermediate_size=96, moe_intermediate_size=32,
            num_experts=4, router_experts=8, num_experts_per_token=2, kv_lora_rank=32, qk_nope_head_dim=32,
            qk_rope_head_dim=16, v_head_dim=32, vocab_size=2000,
            linear_attn_config={"full_attn_layers": [4], "kda_layers": [1, 2, 3], "head_dim": 16, "num_heads": 4,
                                "short_conv_kernel_size": 4})
NEW_METRICS = {"long_join.mfu", "kda.attn_ms", "kda.scan_roofline_pct", "device.idle_pct.long_join"}


def tiny() -> tuple[dict, dict]:
    """The cell and its configuration cut to a CPU's size, in f32, with
    texts of several 64-token chunks; the limits are the configuration's
    own."""
    _, cell, cfg = harness.cell_files(NAME)
    cell, cfg = json.loads(json.dumps(cell)), json.loads(json.dumps(cfg))
    cfg.update(TINY, right_docs=256, words=[100, 200], max_seq_length=256, dtype="float32")
    cell["traffic"].update(pool_requests=3)
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
        i[:, 0] = (i[:, 0] + 128) % 256
        return RMOutput(distances=out.distances, indices=i.tolist())

    monkeypatch.setattr(TorchVS, "__call__", wrong)


def _in_window(monkeypatch, scan):
    """``scan`` in the place of the recurrence over chunk tiles once set-up
    is over."""
    from lotus_tpu_torch.ops import kda

    cell = harness.adapter("long_join").Cell
    window = cell.window

    def faulty(self, seconds):
        monkeypatch.setattr(kda, "scan_chunks", scan)
        return window(self, seconds)

    monkeypatch.setattr(cell, "window", faulty)


def _state_reset_each_chunk(monkeypatch):
    from lotus_tpu_torch.ops import kda

    scan = kda.scan_chunks
    _in_window(monkeypatch, lambda *args: torch.cat([scan(*(x[i : i + 1] for x in args))
                                                     for i in range(args[0].shape[0])]))


def _decay_dropped(monkeypatch):
    from lotus_tpu_torch.ops import kda

    scan = kda.scan_chunks
    _in_window(monkeypatch, lambda q, k, v, g, beta: scan(q, k, v, torch.zeros_like(g), beta))


@pytest.mark.parametrize("fault", [_move_ids, _state_reset_each_chunk, _decay_dropped],
                         ids=["id_moved", "state_reset_each_chunk", "decay_dropped"])
def test_broken_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result, checks = rehearse()
    assert not result["correct"], checks


def test_control_is_not_correct():
    """The fp8 control at the published widths over one period of layers (3
    KDA, the first dense, and 1 latent attention), 8 of the router's 256
    experts held, a 32,768-entry vocabulary and a few short documents: its
    error grows with width and depth, so the tiny model would hide it."""
    cell, cfg = tiny()
    _, _, full = harness.cell_files(NAME)
    cfg.update({k: full[k] for k in TINY if k not in ("num_hidden_layers", "linear_attn_config", "vocab_size",
                                                      "num_experts")},
               num_experts=8, vocab_size=32768, right_docs=64, words=[20, 40], dtype="bfloat16",
               linear_attn_config={**full["linear_attn_config"], "full_attn_layers": [4], "kda_layers": [1, 2, 3]})
    cell["traffic"].update(batch=8, judged_requests=1, judge_docs=6)
    checks = control_kimi.control_checks(cell, cfg, SEED, torch.device("cpu"))
    assert not all(c["ok"] for c in checks), checks


def test_bounds_of_kimi_linear():
    """1.6252 B parameters a token (20 KDA and 7 latent attention layers, the
    dense first layer, and in 26 MoE layers the gate, the shared expert and 8
    x 64 / 256 routed experts), 20,480 operations a scored pair a layer, 7 x
    128^2 a (token, head) of the recurrence, and the recurrence at the
    cell's shape bound by its bytes, about 0.96 ms a layer."""
    _, _, cfg = harness.cell_files(NAME)
    assert round(bounds_kda.weights_per_token(cfg) / 1e9, 4) == 1.6252
    assert bounds_kda.recurrence_flops(cfg) == 7 * 128 * 128
    least = bounds_kda.scan_least_s(cfg, 8 * 8192 * 32)
    assert least["by"] == "bytes" and abs(least["s"] - 8 * 8192 * 32 * 1540 / 3.35e12) < 1e-12
    pairs = 8 * 8192 * 8193 / 2
    from perfbench import bounds_moe

    assert bounds_moe.pair_flops(cfg) == 20_480
    want = 2 * bounds_kda.weights_per_token(cfg) * 65536 + 20_480 * 7 * pairs + 7 * 128 * 128 * 32 * 20 * 65536
    assert abs(bounds_kda.kimi_flops(cfg, 65536, pairs) - want) < 1
