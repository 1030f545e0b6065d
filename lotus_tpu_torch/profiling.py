"""Profiling for the port's compute path: the counterparts of
``lotus_tpu/profiling.py:19-52``, and the program's own spans.

An operator's use::

    from lotus_tpu_torch import profiling

    with profiling.trace("traces"):   # around any calls
        vs(queries, 10, ids=allowed)
    for name, t in profiling.span_totals().items():
        print(name, t.calls, t.device_s, t.host_s)

``trace(dir)`` records ``torch.profiler``'s timeline, the host's and, on a
card, the device's (CUDA activity through CUPTI), and writes it into ``dir``
as a Chrome trace (``chrome://tracing``, Perfetto, TensorBoard's trace
viewer).  Every span of the program (``annotate``) is a region of that trace
on the same clock as the kernels it launched.  ``span_totals()`` gives, for
the latest profiling session, each span's calls and its device, host and
self host seconds.  ``timed`` wall-clocks a region into a sink or the log.

The spans the program opens (``ops/ivf_probe.py``, ``TorchVS.__call__``):
``ivf.search`` (one grouped-probe call) over ``ivf.coarse``, ``ivf.layout``,
``ivf.k1``, ``ivf.pool`` and ``ivf.rescore`` per query slice; ``vs.call``
(one store call) over ``vs.inputs``, ``ivf.subset_rows``,
``ivf.subset_scan`` (an ids search), ``ivf.search`` or ``vs.scan`` (the
other routes), ``vs.wait`` and ``vs.to_lists``.  The sentence-embedding RM
(``models/torch_rm.py``) opens ``rm.call`` (one ``rm(docs)``) over
``rm.tokenize`` (a batch's tokens, on the host) and ``rm.forward`` (a
batch's forward and pooling); DeepSeek-V2 (``models/deepseek_v2.py``)
opens ``mla.attn`` (a layer's attention, projections included),
``moe.shared``, ``moe.route`` and ``moe.experts`` (over ``moe.combine``,
K4 on the card) inside the forward; Kimi-Linear (``models/kimi_linear.py``)
opens the same in its latent attention and MoE layers, and ``kda.attn`` (a
KDA layer: projections, convolutions, gates, recurrence, gated norm and
output projection) over ``kda.scan`` (the recurrence alone, ``ops/kda.py``,
K6 on the card; attribute ``route``, ``kernel`` on the card and ``plain`` on
the CPU); DeepSeek-V3.2 (``models/deepseek_v32.py``) opens ``mla.attn`` over
``dsa.index`` (the lightning indexer's projections, scores and top-k) and
``dsa.attn`` (latent attention over the selection, ``ops/dsa.py``), and the
MoE layer's spans.

The program's counters (``tally``) are device tensors of a session, added to
without a synchronisation while a profiler runs and read by
``counter_totals()`` after it: DeepSeek-V2's ``moe.pairs`` (routed pairs per
layer and expert), ``moe.pairs_max`` (per layer, the most pairs of one
expert, summed over calls) and ``moe.experts_used`` (per layer, the experts
with a pair, summed over calls); Kimi-Linear's ``kda.tokens`` (per layer,
the (token, head) pairs its recurrence ran over, padding included);
DeepSeek-V3.2's ``dsa.scored`` (per layer, the causal (query, key) pairs
the indexer scored), ``dsa.pairs`` (the selected pairs attended) and
``dsa.queries`` (the query rows), padding included.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Iterator

import torch

logger = logging.getLogger("lotus_tpu_torch")

# True while a torch.profiler session runs (any activity).
_profiler_enabled = torch._C._autograd._profiler_enabled

# Spans a session keeps; past it they are counted in ``dropped`` only.
SPAN_CAP = 1 << 16


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Record the block with ``torch.profiler`` (CPU activity, plus CUDA
    activity when a card is present) and write
    ``log_dir/trace_<pid>_<ns>.json``.  The card is synchronised before the
    recording stops, so work the block queued is in the trace.  The block's
    spans form a new session of ``span_totals``."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        _REGISTRY.new_session()
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    logger.info(f"profiling: trace written to {path}")


class _Registry:
    """The spans of the latest session, at most ``cap`` of them.  A session
    starts where a span finds a profiler running after the last span found
    none, or where ``trace`` starts one."""

    def __init__(self, cap: int) -> None:
        self.cap = cap
        self.lock = threading.Lock()
        self.local = threading.local()  # each thread's open spans
        self.requests = itertools.count()
        self.live = False  # whether the last span found a profiler running
        self.session = 0
        self.spans: list[_Span] = []
        self.dropped = 0
        self.counters: dict[str, torch.Tensor] = {}

    def new_session(self) -> None:
        with self.lock:
            self.session += 1
            self.spans = []
            self.dropped = 0
            self.counters = {}
            self.live = True

    def open_spans(self) -> list[_Span]:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_REGISTRY = _Registry(SPAN_CAP)


class _Off:
    """What ``annotate`` returns with no profiler running: nothing to do."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: Any) -> None:
        return None


_OFF = _Off()


class _Span:
    """One span while a profiler runs: a ``record_function`` region, host
    ``perf_counter_ns`` at entry and exit, and where CUDA is initialised a
    timing event pair on the current stream, read only by ``span_totals``."""

    __slots__ = ("name", "attrs", "session", "index", "parent", "request",
                 "t0", "t1", "ev0", "ev1", "_region")

    def __init__(self, name: str, attrs: dict[str, Any]) -> None:
        self.name, self.attrs = name, attrs
        self.t1 = None
        self.ev0 = self.ev1 = None

    def __enter__(self) -> "_Span":
        reg = _REGISTRY
        if not reg.live:
            reg.new_session()
        stack = reg.open_spans()
        up = stack[-1] if stack and stack[-1].session == reg.session else None
        self.session = reg.session
        # -1: a root; -2: a child of a span past the cap.
        self.parent = -1 if up is None else up.index if up.index >= 0 else -2
        self.request = next(reg.requests) if up is None else up.request
        with reg.lock:
            if len(reg.spans) < reg.cap:
                self.index = len(reg.spans)
                reg.spans.append(self)
            else:
                self.index = -1
                reg.dropped += 1
        stack.append(self)
        self._region = torch.profiler.record_function(self.name)
        self._region.__enter__()
        if torch.cuda.is_initialized():
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.t1 = time.perf_counter_ns()
        if self.ev0 is not None:
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev1.record()
        self._region.__exit__(*exc)
        _REGISTRY.open_spans().pop()


def annotate(name: str, **attrs: Any):
    """The program's span: a named region, ``with annotate(name, **attrs):``.

    With no ``torch.profiler`` session running it checks that one flag and
    returns a shared no-op: no ``record_function``, event, clock read or
    allocation of its own.  With one running it opens
    ``record_function(name)`` (a region of the Chrome trace, on the
    kernels' clock) and records into the session's registry its name, its
    parent span, its request (the root span's sequence number, shared by
    every span of one call), its host interval and ``attrs``; where CUDA is
    initialised, also a timing event pair on the current stream, never
    synchronised inside the span."""
    if not _profiler_enabled():
        _REGISTRY.live = False
        return _OFF
    return _Span(name, attrs)


@dataclass
class SpanTotal:
    """One span name's totals over a session: ``calls``, the host seconds
    from entry to exit, the host seconds outside child spans, the device
    seconds between its events (its host seconds on the CPU, where the work
    is synchronous) and the calls that had no parent span."""

    calls: int = 0
    host_s: float = 0.0
    self_host_s: float = 0.0
    device_s: float = 0.0
    roots: int = 0


class SpanTotals(dict):
    """``{name: SpanTotal}`` of one session, with the session's number and
    the spans past the registry's cap (``dropped``)."""

    def __init__(self, session: int, dropped: int) -> None:
        super().__init__()
        self.session, self.dropped = session, dropped


def span_records() -> list[dict[str, Any]]:
    """The latest session's closed spans, in entry order: name, index,
    parent index (-1 for a root, -2 under a span past the cap), request, host start and end
    (``perf_counter_ns``), device seconds and ``attrs``.  Resolves the CUDA
    events, waiting for the work they close over."""
    reg = _REGISTRY
    with reg.lock:
        spans = list(reg.spans)
    out = []
    for sp in spans:
        if sp.t1 is None:
            continue
        host_s = (sp.t1 - sp.t0) * 1e-9
        if sp.ev1 is not None:
            sp.ev1.synchronize()
            device_s = sp.ev0.elapsed_time(sp.ev1) * 1e-3
        else:
            device_s = host_s
        out.append({"name": sp.name, "index": sp.index, "parent": sp.parent, "request": sp.request,
                    "t0_ns": sp.t0, "t1_ns": sp.t1, "device_s": device_s, "attrs": sp.attrs})
    return out


def span_totals() -> SpanTotals:
    """Per span name, the latest session's ``SpanTotal``.  A span still open
    is left out; ``dropped`` counts the spans past the cap."""
    reg = _REGISTRY
    with reg.lock:
        session, dropped = reg.session, reg.dropped
    records = span_records()
    children_s: dict[int, float] = {}
    for r in records:
        if r["parent"] >= 0:
            children_s[r["parent"]] = children_s.get(r["parent"], 0.0) + (r["t1_ns"] - r["t0_ns"]) * 1e-9
    totals = SpanTotals(session, dropped)
    for r in records:
        t = totals.setdefault(r["name"], SpanTotal())
        host_s = (r["t1_ns"] - r["t0_ns"]) * 1e-9
        t.calls += 1
        t.host_s += host_s
        t.self_host_s += host_s - children_s.get(r["index"], 0.0)
        t.device_s += r["device_s"]
        t.roots += r["parent"] == -1
    return totals


def active() -> bool:
    """Whether a profiler session runs: what a caller checks before it works
    out values to ``tally``."""
    return _profiler_enabled()


def tally(name: str, row: int, values: torch.Tensor, rows: int) -> None:
    """Adds ``values`` (1-D, integer) into row ``row`` of the session's
    counter ``name``, a (``rows``, len(values)) int64 tensor on the values'
    device made at its first tally, while a profiler runs: one device add,
    no synchronisation.  With no profiler running it checks that one flag
    and does nothing."""
    if not _profiler_enabled():
        return
    reg = _REGISTRY
    if not reg.live:
        reg.new_session()
    counter = reg.counters.get(name)
    if counter is None:
        counter = reg.counters[name] = torch.zeros((rows, values.numel()), dtype=torch.int64, device=values.device)
    counter[row].add_(values)


def counter_totals() -> dict[str, torch.Tensor]:
    """The latest session's counters, each copied to the host (which waits
    for the work that added to it)."""
    with _REGISTRY.lock:
        counters = dict(_REGISTRY.counters)
    return {name: c.cpu() for name, c in counters.items()}


@contextlib.contextmanager
def timed(name: str, sink: dict[str, Any] | None = None) -> Iterator[None]:
    """Wall-clock a region into ``sink`` (seconds added under ``name``) or
    the log.  Work a region queues on the card counts only where the region
    waits for it (the models' and stores' entry points return host arrays,
    so theirs does)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if sink is not None:
            sink[name] = sink.get(name, 0.0) + dt
        else:
            logger.info(f"profiling: {name} took {dt * 1000:.1f} ms")
