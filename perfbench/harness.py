"""The benchmark's frame: the cell's files found by name, the import guard,
the device's description, spans, the traced stretch and its reduction, the
per-layer readers and the result line."""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Iterator

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lotus_tpu")
CACHE_DIR = ROOT / "build" / "perfbench_cache"


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole (``lotus_tpu_torch`` is not ``lotus_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def fixed_cache_dirs() -> None:
    """Kernel caches inside the checkout, at fixed paths, so that only a
    checkout's first run builds; JAX kept out of libraries that would load it."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    os.environ["USE_FLAX"] = "0"


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(name: str) -> tuple[dict, dict, dict]:
    """(the BENCHMARK.json entry, the cell's file, its configuration's file).
    A cell with a file and no entry yet (one kept for a later benchmark
    change) runs on one chip and reports no metric."""
    path = BENCH / "cells" / f"{name}.json"
    if not path.exists():
        raise SystemExit(f"unknown workload {name!r}")
    cell = load_json(path)
    entry = next((w for w in spec()["workloads"] if w["name"] == name),
                 {"name": name, "config": cell["config"], "chips": 1})
    return entry, cell, load_json(BENCH / "configs" / f"{cell['config']}.json")


def metrics_of(name: str, kind: str) -> list[dict]:
    """The cell's ``end_to_end`` or ``per_layer`` metrics, in file order
    (none for a cell that ``BENCHMARK.json`` does not list)."""
    if not any(w["name"] == name for w in spec()["workloads"]):
        return []
    return [m for m in spec()[kind] if name in m.get("workloads", [name])]


_MODULES: dict[Path, Any] = {}


def load_module(path: Path):
    """A file of the benchmark's (its name may hold dots), loaded once."""
    if path in _MODULES:
        return _MODULES[path]
    mod_spec = importlib.util.spec_from_file_location(f"perfbench_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    _MODULES[path] = module
    return module


def adapter(name: str):
    return load_module(BENCH / "adapters" / f"{name}.py")


def read_per_layer(name: str, rec: dict) -> float | None:
    """One per-layer metric from the traced run's records, by its reader
    ``metrics/<name>.py``; None where it finds nothing to read."""
    return load_module(BENCH / "metrics" / f"{name}.py").read(rec)


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """A benchmark span around a call into a layer: a named region in the
    trace when the profiler runs."""
    import torch

    with torch.profiler.record_function(name):
        yield


def device_info(count: int = 1) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}


class Tracer:
    """Profiles one steady stretch of the window (``--trace 1``): CPU and
    CUDA activity from ``start_s`` into the window for ``length_s``; the
    stretch is wrapped in the span ``bench.trace``."""

    def __init__(self, enabled: bool, start_s: float, length_s: float, tmp_dir: str):
        self.enabled, self.start_s, self.length_s, self.tmp_dir = enabled, start_s, length_s, tmp_dir
        self.active = False
        self.done = False
        self.summary: dict | None = None
        self.steps = 0  # requests completed inside the stretch
        self.pre: dict | None = None  # the window before the stretch: its seconds and the adapter's counters

    def tick(self, elapsed: float, snapshot=None) -> None:
        """Called between requests with the window's elapsed seconds; at the
        stretch's start ``snapshot()`` (the adapter's counters so far) is
        kept with ``elapsed`` as ``pre``: counters read over the window
        before the profiler first ran."""
        if not self.enabled or self.done:
            return
        if not self.active and elapsed >= self.start_s:
            self.pre = {"seconds": elapsed, **(snapshot() if snapshot else {})}
            self.start()
        elif self.active and now() - self.t_on >= self.length_s:
            self.stop()

    def step(self) -> None:
        """One request completed."""
        if self.active:
            self.steps += 1

    def start_profiler(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
        self._prof = profile(activities=[ProfilerActivity.CPU, *cuda])
        self._prof.start()

    def begin(self) -> None:
        """Opens the stretch's span in a running profiler."""
        import torch

        self._region = torch.profiler.record_function("bench.trace")
        self._region.__enter__()
        self.active = True
        self.t_on = now()

    def end(self) -> None:
        """Closes the stretch's span, the card synchronised first."""
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._region.__exit__(None, None, None)
        self.active = False

    def start(self) -> None:
        self.start_profiler()
        self.begin()

    def stop(self) -> None:
        """Ends the stretch and the profiler; the trace is read by
        ``finish`` after the window."""
        if not self.active:
            return
        self.end()
        self._prof.stop()
        self.done = True

    def finish(self) -> dict | None:
        if self.summary is None and self.done:
            path = os.path.join(self.tmp_dir, f"trace_{os.getpid()}.json")
            self._prof.export_chrome_trace(path)
            del self._prof
            try:
                self.summary = reduce_trace(path)
            finally:
                os.remove(path)
            self.summary["steps"] = self.steps
            self.summary["pre"] = self.pre
        return self.summary


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def reduce_trace(path: str) -> dict:
    """A Chrome trace of one stretch to what the readers need: the
    stretch's seconds (the ``bench.trace`` span), the device's busy seconds
    (the union of its operations' intervals inside it), each device
    operation (name, start s, seconds) and each benchmark span."""
    events = load_json(Path(path))
    events = events["traceEvents"] if isinstance(events, dict) else events
    window = next((e for e in events if e.get("name") == "bench.trace" and e.get("cat") == "user_annotation"), None)
    if window is None:
        raise RuntimeError("the trace holds no bench.trace span")
    lo, hi = float(window["ts"]), float(window["ts"]) + float(window["dur"])
    dev = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
            s, t = max(float(e["ts"]), lo), min(float(e["ts"]) + float(e.get("dur", 0.0)), hi)
            if t > s:
                dev.append((str(e.get("name")), s, t))
    dev.sort(key=lambda x: x[1])
    merged: list[list[float]] = []
    for _, s, t in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    spans = [(str(e["name"]), float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith("bench.")
             and e.get("name") != "bench.trace" and e.get("ph") == "X"]
    us = 1e-6
    return {
        "window_s": (hi - lo) * us,
        "busy_s": sum(t - s for s, t in merged) * us,
        "device_ops": [(n, (s - lo) * us, (t - s) * us) for n, s, t in dev],
        "busy": [((s - lo) * us, (t - lo) * us) for s, t in merged],
        "spans": [(n, (s - lo) * us, (t - lo) * us) for n, s, t in spans],
    }


def breakdown(tr: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps summed by the innermost benchmark span the host was in."""
    by_name: dict[str, float] = {}
    for name, _, dur in tr["device_ops"]:
        by_name[name] = by_name.get(name, 0.0) + dur
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:top]
    edges = [0.0, *[x for iv in tr["busy"] for x in iv], tr["window_s"]]
    gaps: dict[str, float] = {}
    for s, t in zip(edges[0::2], edges[1::2]):
        if t <= s:
            continue
        mid = 0.5 * (s + t)
        inside = [sp for sp in tr["spans"] if sp[1] <= mid <= sp[2]]
        label = min(inside, key=lambda sp: sp[2] - sp[1])[0] if inside else "bench.between_calls"
        gaps[label] = gaps.get(label, 0.0) + (t - s)
    idle = sorted(gaps.items(), key=lambda x: -x[1])[:top]
    return {"device_ops": [[n[:160], v] for n, v in ops], "idle_gaps": [[n, v] for n, v in idle]}


def spread_of_requests(ends: list[float] | None) -> str:
    """A closed loop's request seconds (from the previous one's end), as
    quartiles, for the log."""
    import numpy as np

    if not ends or len(ends) < 4:
        return ""
    q = np.percentile(np.diff([0.0, *ends]), [0, 25, 50, 75, 100])
    return f"; {len(ends)} requests, seconds each min/q1/median/q3/max " + "/".join(f"{x:.4f}" for x in q)


def finite(x: float) -> float:
    """A compared number for the JSON line: a missing answer's infinite
    gap reads as 1e300."""
    return x if x == x and abs(x) != float("inf") else 1e300


def emit(result: dict, checks: list[dict]) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output, the checks under its last key."""
    result["checks"] = {c["name"]: {"value": finite(c["value"]), "limit": c["limit"],
                                    "bound": "at most" if c["kind"] == "max" else "at least"} for c in checks}
    for c in checks:
        word = "<=" if c["kind"] == "max" else ">="
        print(f"check {c['name']}: {c['value']!r} {word} {c['limit']!r}: {'ok' if c['ok'] else 'FAILED'}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def now() -> float:
    return time.perf_counter()
