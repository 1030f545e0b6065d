"""The benchmark's readers of the program's spans (``perfbench/metrics/``,
``source`` ``program_span``), each loaded by its path, on the CPU: None
outside a traced run, on an empty session and on one that dropped spans; a
positive number after a tiny grouped-probe search or ``TorchVS`` ids search
under a ``torch.profiler`` session."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from lotus_tpu_torch import TorchVS, profiling
from lotus_tpu_torch.ops.bench_data import synth_ivf_device_build
from lotus_tpu_torch.ops.ivf_probe import ivf_search_grouped_probe

METRICS = Path(__file__).resolve().parent.parent / "perfbench" / "metrics"
# Each reader and the call whose spans it reads.
READERS = {
    "grouped_probe.coarse_ms": "probe",
    "grouped_probe.layout_ms": "probe",
    "grouped_probe.pool_ms": "probe",
    "grouped_probe.rescore_ms": "probe",
    "ids.rows_ms": "ids",
    "vs.host_in_ms": "ids",
    "vs.host_out_ms": "ids",
}
TRACED = {"trace": {"steps": 2}}  # what a traced run's record holds, as the readers need it


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"reader_{name.replace('.', '_')}", METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@pytest.fixture(scope="module")
def calls(tmp_path_factory):
    built = synth_ivf_device_build(n=2**13, d=32, nlist=8, n_clusters=8, chunk=2**12, queries_b=64, gt_queries=8,
                                   k=10, seed=0, device="cpu")
    emb = np.random.default_rng(0).standard_normal((256, 16)).astype(np.float32)
    vs = TorchVS(index_type="ivf", nlist=4, device_dtype="int8", device="cpu")
    vs.index([], emb, str(tmp_path_factory.mktemp("ids") / "idx"))
    ids = list(range(0, 256, 2))
    vs(emb[:8], 3, ids=ids)
    return {
        "probe": lambda: ivf_search_grouped_probe(built["state"], built["queries"], 10, nprobe=4, rescore=24,
                                                  int8_queries=True, query_chunk=32),
        "ids": lambda: vs(emb[:8], 3, ids=ids),
    }


def _profiled(fn, times=2):
    with profiling.annotate("outside"):  # a span with no profiler: the next profiled span starts a session
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(times):
            fn()


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_the_calls_spans(name, calls):
    read = _reader(name)
    _profiled(calls[READERS[name]])
    value = read(TRACED)
    assert value is not None and np.isfinite(value) and value > 0
    assert read({"window_s": 1.0}) is None  # no traced stretch in the record


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_finds_nothing_in_an_empty_session(name, calls, tmp_path):
    read = _reader(name)
    other = "ids" if READERS[name] == "probe" else "probe"
    _profiled(calls[other])  # the other call's spans only
    assert read(TRACED) is None
    with profiling.trace(str(tmp_path)):
        pass
    assert dict(profiling.span_totals()) == {} and read(TRACED) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_refuses_a_session_that_dropped_spans(name, calls, monkeypatch):
    read = _reader(name)
    monkeypatch.setattr(profiling._REGISTRY, "cap", 8)
    _profiled(calls[READERS[name]])
    assert profiling.span_totals().dropped > 0 and read(TRACED) is None
