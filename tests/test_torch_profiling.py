"""``lotus_tpu_torch.profiling`` on the CPU: ``trace`` writes a Chrome
trace that names the ``annotate`` regions and the ops inside them, and
``timed`` fills its sink (and the log without one) as
``lotus_tpu.profiling.timed`` does."""

import glob
import json
import logging

import numpy as np
import torch

from lotus_tpu import profiling as ref_profiling
from lotus_tpu_torch import TorchVS, profiling


def test_trace_names_annotated_regions(tmp_path):
    emb = np.random.default_rng(0).standard_normal((256, 16)).astype(np.float32)
    vs = TorchVS(index_type="flat", device="cpu")
    vs.index([], emb, str(tmp_path / "idx"))
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("store call"):
            vs(emb[:4], 3)
        with profiling.annotate("matmul"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = glob.glob(str(tmp_path / "trace" / "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"store call", "matmul", "aten::mm"} <= names
    region = next(e for e in events if e.get("name") == "matmul")
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert region["dur"] > 0 and any(region["ts"] <= e["ts"] <= region["ts"] + region["dur"] for e in mm)


def test_timed_sink_and_log_as_the_reference(caplog):
    got, want = {}, {}
    for mod, sink in ((profiling, got), (ref_profiling, want)):
        for name in ("a", "b", "a"):
            with mod.timed(name, sink):
                pass
    assert sorted(got) == sorted(want) == ["a", "b"] and all(v >= 0.0 for v in got.values())
    with caplog.at_level(logging.INFO, logger="lotus_tpu_torch"):
        with profiling.timed("logged"):
            pass
    assert any("profiling: logged took" in r.getMessage() for r in caplog.records)
