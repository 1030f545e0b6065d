"""Each cell rehearsed end to end on the CPU at a tiny size, through the
kernels' plain versions (the look for a card skipped); each with its timed
path broken underneath, which has to come out not correct; and each
cell's control, which has to come out not correct."""

from __future__ import annotations

import json
import sys
import textwrap

import numpy as np
import pytest
import torch

from perfbench import control, harness, run

SEED = 2**31 + 4321
# Every cell file, those BENCHMARK.json lists and those kept for a later change.
CELLS = sorted(p.stem for p in (harness.BENCH / "cells").glob("*.json"))
E5_TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128, vocab_size=2000)


def tiny(name: str) -> tuple[dict, dict]:
    """The cell and its configuration cut to a CPU's size; the limits are
    the configuration's own."""
    _, cell, cfg = harness.cell_files(name)
    cell, cfg = json.loads(json.dumps(cell)), json.loads(json.dumps(cfg))
    tr = cell["traffic"]
    if cell["adapter"] in ("ivf_bulk", "ivf_served"):
        cfg.update(n=16384, d=64, n_clusters=256, chunk=4096, nlist=16, block_align=512, nprobe=16, rescore=48, query_chunk=64,
                   check_rows=64, kmeans_iters=3)
        tr.update(batch=128, pool_batches=4, judge_queries=64, warmup_batches=1, pool=256, warmup_requests=2,
                  connections=4, rate_per_s=150)
    else:
        cfg["model"].update(E5_TINY)
        cfg.update(right_docs=1024, store=dict(cfg["store"], nlist=2), dtype="float32")
        tr.update(batch=64, judge_docs=32, pool_requests=4, judged_requests=2, pool_batches=2)
    cell.update(trace_start_s=0.2, trace_s=0.4)
    return cell, cfg


def rehearse(name: str, trace: bool = False, seconds: float = 1.0) -> tuple[dict, list[dict]]:
    cell, cfg = tiny(name)
    return run.run_cell(name, SEED, seconds, trace, device="cpu", cell=cell, config=cfg)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_rehearsed_on_cpu(name, trace):
    result, checks = rehearse(name, trace, seconds=2.5 if trace else 1.0)
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["correct"], checks
    kind = "per_layer" if trace else "end_to_end"
    expected = {m["name"] for m in harness.metrics_of(name, kind)}
    assert set(result["metrics"]) <= expected
    if not trace:
        assert set(result["metrics"]) == expected
    else:
        assert result["breakdown"]["idle_gaps"] and result["device"]["window_s"] > 0
    assert all(np.isfinite(m["value"]) for m in result["metrics"].values())


def _alter(ids):
    """An answer altered where it is produced: each first id moved half the
    collection away."""
    ids = ids.clone() if isinstance(ids, torch.Tensor) else np.array(ids)
    ids[:, 0] = (ids[:, 0] + 8192) % 16384 if ids.max() >= 1024 else (ids[:, 0] + 512) % 1024
    return ids


def _halve(a):
    """Half of the batch left out: its second half answered with the first's."""
    a = a.clone() if isinstance(a, torch.Tensor) else np.array(a)
    h = a.shape[0] // 2
    if h:
        a[h : 2 * h] = a[:h]
    return a


FAULTS = {"alter": _alter, "halve": _halve}


def _break_ivf(monkeypatch, fault):
    from perfbench.adapters import _ivf

    make = _ivf.search_fn

    def broken(cfg):
        search = make(cfg)

        def wrong(state, xq, **kw):
            d, i = search(state, xq, **kw)
            return (FAULTS[fault](d) if fault == "halve" else d), FAULTS[fault](i)

        return wrong

    monkeypatch.setattr(_ivf, "search_fn", broken)
    return broken


def _break_vs(monkeypatch, fault):
    from lotus_tpu_torch import TorchVS
    from lotus_tpu_torch.types import RMOutput

    call = TorchVS.__call__

    def wrong(self, q, k, ids=None, **kw):
        out = call(self, q, k, ids=ids, **kw)
        d, i = np.asarray(out.distances), np.asarray(out.indices)
        return RMOutput(distances=(FAULTS[fault](d) if fault == "halve" else d).tolist(),
                        indices=FAULTS[fault](i).tolist())

    monkeypatch.setattr(TorchVS, "__call__", wrong)


CHILD_FAULT = textwrap.dedent("""
    import runpy, sys
    sys.path.insert(0, {root!r})
    from perfbench.adapters import _ivf
    from perfbench.tests import test_perfbench_cells as t
    make = _ivf.search_fn
    def broken(cfg):
        search = make(cfg)
        def wrong(state, xq, **kw):
            d, i = search(state, xq, **kw)
            return d, t.FAULTS[{fault!r}](i)
        return wrong
    _ivf.search_fn = broken
    sys.argv = sys.argv[1:]
    runpy.run_path(sys.argv[0], run_name="__main__")
""")


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS for f in FAULTS if not (c.endswith("single") and
                                                                                       f == "halve")])
def test_broken_path_is_not_correct(name, fault, monkeypatch):
    _, cell, _ = harness.cell_files(name)
    if cell["adapter"] == "ivf_bulk":
        _break_ivf(monkeypatch, fault)
    elif cell["adapter"] == "ivf_served":
        served = harness.adapter("ivf_served")
        code = CHILD_FAULT.format(root=str(harness.ROOT), fault=fault)
        monkeypatch.setattr(served, "CHILD", [sys.executable, "-c", code, *served.CHILD[1:]])
    else:
        _break_vs(monkeypatch, fault)
    result, checks = rehearse(name)
    assert not result["correct"], checks


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """Config 4's control at the tiny size; e5-base-v2's at its published
    widths and depth over a few texts (the fp8 control's error grows with
    depth and width, so a tiny model would hide it)."""
    cell, cfg = tiny(name)
    if cell["adapter"] in ("ivf_bulk", "ivf_served"):
        checks = control.ivf_control(cell, cfg, SEED, torch.device("cpu"))
    else:
        _, _, cfg = harness.cell_files(name)
        cfg["right_docs"] = 64
        cell["traffic"].update(batch=16, judged_requests=1, pool_batches=1, judge_docs=16)
        checks = control.e5_control(cell, cfg, SEED, torch.device("cpu"))
    assert not all(c["ok"] for c in checks), checks
