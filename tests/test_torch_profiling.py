"""``lotus_tpu_torch.profiling`` on the CPU: ``trace`` writes a Chrome
trace that names the ``annotate`` regions and the ops inside them, and
``timed`` fills its sink (and the log without one) as
``lotus_tpu.profiling.timed`` does.  The program's spans: nothing recorded
and nothing called with no profiler running; with one, the span tree, its
host and self times, sessions and the cap; and the spans the grouped probe
and ``TorchVS`` open on each route.  On the card (``cuda``-marked, skipped
without one): a trace's ``annotate`` regions carry device times.  Only the
reference test imports ``lotus_tpu``, so the file runs on a machine
without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_profiling.py"""

import glob
import json
import logging
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lotus_tpu_torch import TorchVS, profiling
from lotus_tpu_torch.ops.bench_data import synth_ivf_device_build
from lotus_tpu_torch.ops.ivf_probe import ivf_search_grouped_probe

STAGES = ("ivf.coarse", "ivf.layout", "ivf.k1", "ivf.pool", "ivf.rescore")


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
    from lotus_tpu import profiling as ref_profiling

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


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


def _trace_events(trace_dir):
    (path,) = glob.glob(str(trace_dir / "*.json"))
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _boom(*_, **__):
    raise AssertionError("called with no profiler running")


class _NoClock:
    def __getattr__(self, name):
        return _boom


def test_span_off_records_and_calls_nothing(tmp_path, monkeypatch):
    _profiled(lambda: [profiling.annotate("before").__enter__(), None])  # a session with an open span
    before = profiling.span_totals()
    monkeypatch.setattr(torch.profiler, "record_function", _boom)
    monkeypatch.setattr(torch.cuda, "Event", _boom)
    monkeypatch.setattr(profiling, "time", _NoClock())
    spans = [profiling.annotate("off.region", batch=4) for _ in range(3)]
    assert all(sp is spans[0] for sp in spans)  # one shared no-op: nothing allocated per span
    tracemalloc.start()
    try:
        snap0 = tracemalloc.take_snapshot()
        for _ in range(200):
            with profiling.annotate("off.region"):
                pass
        grew = tracemalloc.take_snapshot().compare_to(snap0, "filename")
    finally:
        tracemalloc.stop()
    assert not [d for d in grew if d.traceback[0].filename == profiling.__file__ and d.size_diff > 0]
    after = profiling.span_totals()
    assert (after.session, dict(after)) == (before.session, dict(before))
    monkeypatch.undo()
    with profiling.trace(str(tmp_path / "trace")):
        pass
    names = {e.get("name") for e in _trace_events(tmp_path / "trace") if e.get("cat") == "user_annotation"}
    assert "off.region" not in names
    assert profiling.span_records() == [] and dict(profiling.span_totals()) == {}


def test_span_tree_times_and_sessions():
    def calls():
        for _ in range(2):
            with profiling.annotate("root", batch=3):
                with profiling.annotate("a"):
                    torch.ones(32, 32) @ torch.ones(32, 32)
                with profiling.annotate("b"):
                    with profiling.annotate("c"):
                        torch.ones(32, 32) @ torch.ones(32, 32)

    _profiled(calls)
    recs = profiling.span_records()
    assert [r["name"] for r in recs] == ["root", "a", "b", "c"] * 2
    by = {r["index"]: r for r in recs}
    for r in recs:
        want = {"root": None, "a": "root", "b": "root", "c": "b"}[r["name"]]
        assert (by[r["parent"]]["name"] if r["parent"] >= 0 else None) == want
        assert r["request"] == by[r["index"] - r["index"] % 4]["request"]
        assert r["t0_ns"] <= r["t1_ns"] and r["device_s"] == (r["t1_ns"] - r["t0_ns"]) * 1e-9
    assert recs[0]["request"] != recs[4]["request"] and recs[0]["attrs"] == {"batch": 3}
    tot = profiling.span_totals()
    assert tot.dropped == 0 and {n: (t.calls, t.roots) for n, t in tot.items()} == {
        "root": (2, 2), "a": (2, 0), "b": (2, 0), "c": (2, 0)}
    for name, children in (("root", ("a", "b")), ("b", ("c",)), ("a", ()), ("c", ())):
        t = tot[name]
        inner = sum(tot[c].host_s for c in children)
        assert t.host_s > 0 and t.self_host_s >= 0 and t.self_host_s + inner <= t.host_s * (1 + 1e-9)
        assert t.device_s == pytest.approx(t.host_s)
    session = tot.session
    _profiled(calls)  # no span between the two profilers: one session
    assert profiling.span_totals().session == session and profiling.span_totals()["root"].calls == 4
    with profiling.annotate("off"):
        pass
    _profiled(calls)  # a profiler after a span that found none: a new session
    tot = profiling.span_totals()
    assert tot.session == session + 1 and tot["root"].calls == 2


def test_spans_past_the_cap_are_dropped(monkeypatch):
    monkeypatch.setattr(profiling._REGISTRY, "cap", 3)

    def calls():
        with profiling.annotate("root"):
            for _ in range(4):
                with profiling.annotate("leaf"):
                    pass

    with profiling.annotate("off"):
        pass
    _profiled(calls)
    tot = profiling.span_totals()
    assert tot.dropped == 2 and tot["root"].calls == 1 and tot["leaf"].calls == 2
    assert len(profiling.span_records()) == 3


@pytest.fixture(scope="module")
def residual_store():
    return synth_ivf_device_build(n=2**13, d=32, nlist=8, n_clusters=8, chunk=2**12, queries_b=64, gt_queries=8,
                                  k=10, seed=0, device="cpu")


@pytest.mark.parametrize("query_chunk,slices", [(None, 1), (24, 3), (32, 2)])
def test_grouped_probe_spans_per_slice(residual_store, query_chunk, slices):
    state, xq = residual_store["state"], residual_store["queries"]
    assert state["meta"]["encoding"] == "residual_int8" and state["ivf_vectors"].shape[0] % 1024 == 0
    want = ivf_search_grouped_probe(state, xq, 10, nprobe=4, rescore=24, int8_queries=True)
    got = _profiled(lambda: ivf_search_grouped_probe(state, xq, 10, nprobe=4, rescore=24, int8_queries=True,
                                                     query_chunk=query_chunk))
    assert torch.equal(got[1], want[1])
    recs = profiling.span_records()
    assert [r["name"] for r in recs] == ["ivf.search", *STAGES * slices]
    assert recs[0]["parent"] == -1 and recs[0]["attrs"] == {"batch": 64}
    assert all(r["parent"] == 0 and r["request"] == recs[0]["request"] for r in recs[1:])
    tot = profiling.span_totals()
    assert tot["ivf.search"].roots == 1 and all(tot[s].calls == slices and tot[s].roots == 0 for s in STAGES)
    # On the CPU the layout and the pool run their kernels' plain versions.
    routes = [(r["name"], r["attrs"]["route"]) for r in recs if r["name"] in ("ivf.layout", "ivf.pool")]
    assert routes == [("ivf.layout", "plain"), ("ivf.pool", "plain")] * slices


def _store(tmp_path, route):
    """A TorchVS of the route's kind, its queries, and the call's arguments."""
    rng = np.random.default_rng(0)
    n = 2048 if route == "grouped_probe" else 256
    emb = rng.standard_normal((n, 16)).astype(np.float32)
    if route == "flat":
        vs = TorchVS(index_type="flat", device="cpu")
    else:
        vs = TorchVS(index_type="ivf", nlist=16 if route == "window_probe" else 4, device_dtype="int8", device="cpu")
    vs.index([], emb, str(tmp_path / "idx"))
    kwargs = {"ids": list(range(0, n, 2))} if route == "ids" else {}
    if route == "grouped_probe":
        kwargs["query_chunk"] = 4
    if route == "window_probe":  # B * nprobe < nlist
        kwargs["nprobe"] = 1
    return vs, emb[:8], kwargs


ROUTE_SPANS = {
    "ids": ["vs.inputs", "ivf.subset_rows", "ivf.subset_scan", "vs.wait", "vs.to_lists"],
    "flat": ["vs.inputs", "vs.scan", "vs.wait", "vs.to_lists"],
    "scan": ["vs.inputs", "vs.scan", "vs.wait", "vs.to_lists"],
    "window_probe": ["vs.inputs", "vs.scan", "vs.wait", "vs.to_lists"],
    "grouped_probe": ["vs.inputs", "ivf.search", "vs.wait", "vs.to_lists"],
}


@pytest.mark.parametrize("route", sorted(ROUTE_SPANS))
def test_store_call_spans(tmp_path, route):
    vs, q, kwargs = _store(tmp_path, route)
    want = vs(q, 3, **kwargs)
    got = _profiled(lambda: vs(q, 3, **kwargs))
    assert got.indices == want.indices
    if route in vs.stats["routes"]:
        assert vs.stats["routes"][route] == 2
    recs = profiling.span_records()
    assert recs[0]["name"] == "vs.call" and recs[0]["parent"] == -1
    assert recs[0]["attrs"] == {"ids": len(kwargs["ids"]) if "ids" in kwargs else None, "batch": 8}
    assert [r["name"] for r in recs if r["parent"] == 0] == ROUTE_SPANS[route]
    assert all(r["request"] == recs[0]["request"] for r in recs)
    if route == "grouped_probe":
        assert [r["name"] for r in recs if r["name"] in STAGES] == list(STAGES) * 2
    tot = profiling.span_totals()
    assert tot["vs.call"].roots == 1 and sum(t.roots for t in tot.values()) == 1


def test_trace_holds_every_span(tmp_path):
    vs, q, kwargs = _store(tmp_path, "ids")
    vs(q, 3, **kwargs)
    with profiling.trace(str(tmp_path / "trace")):
        vs(q, 3, **kwargs)
        vs(q, 3, **kwargs)
    events = [e for e in _trace_events(tmp_path / "trace") if e.get("cat") == "user_annotation"]
    names = sorted(r["name"] for r in profiling.span_records())
    assert len(names) == 12 and sorted(e["name"] for e in events) == names


@pytest.mark.cuda
def test_annotated_regions_carry_device_times_on_gpu(tmp_path):
    """``profiling.trace`` around one encode batch of an RM at
    all-MiniLM-L6-v2's widths (64 documents of 150-300 words at 256
    tokens) and one call of a Flat store under ``scan="pallas"`` (K2) over
    its 384-d embeddings, each inside ``annotate`` and ``timed``: the Chrome
    trace holds K2's ``scan_kernel`` with device times and both regions
    with host and device times, and ``timed``'s sink both regions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: device times exist only there")
    from torch_card_files import seeded_docs, seeded_words, write_checkpoint, write_wordpiece

    from lotus_tpu_torch.models import TorchSentenceEncoderRM
    from lotus_tpu_torch.ops.bench_data import corpus_centers, gen_chunk

    words = seeded_words(70, 2000)
    model = str(tmp_path / "minilm")
    write_checkpoint(model, dict(model_type="bert", vocab_size=write_wordpiece(model, words), hidden_size=384,
                                 num_hidden_layers=6, num_attention_heads=12, intermediate_size=1536))
    rm = TorchSentenceEncoderRM(model=model, max_seq_length=256)
    dev = torch.device("cuda")
    vs = TorchVS(index_type="flat", scan="pallas")
    vs.index([], gen_chunk(71, 0, corpus_centers(71, 64, 384, dev), 10_240, 2.5).cpu().numpy(), str(tmp_path / "idx"))
    docs = seeded_docs(words, [(150, 300)], 64, 70)
    qv = rm(docs[:8])
    vs(qv, 10)  # loads the store
    sink: dict = {}
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("encode batch"), profiling.timed("encode batch", sink):
            rm(docs)
        with profiling.annotate("store call (K2)"), profiling.timed("store call (K2)", sink):
            vs(qv, 10)
    events = _trace_events(tmp_path / "trace")
    regions = ("encode batch", "store call (K2)")
    scan = [e for e in events if e.get("cat") == "kernel" and "scan_kernel" in e.get("name", "")]
    on_device = {r: sum(e["dur"] for e in events if e.get("cat") == "gpu_user_annotation" and e.get("name") == r)
                 for r in regions}
    on_host = {r: sum(e["dur"] for e in events if e.get("cat") == "user_annotation" and e.get("name") == r)
               for r in regions}
    assert scan and all(e["dur"] > 0 for e in scan), "the trace holds no scan_kernel with a device time"
    assert all(on_host[r] > 0 and on_device[r] > 0 for r in regions), "an annotate region lacks its times"
    assert set(sink) == set(regions), "timed's sink lacks a region"
