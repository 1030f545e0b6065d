"""Profiling helpers for the port's compute path: the counterparts of
``lotus_tpu/profiling.py:19-52``.

``with trace(dir):`` records ``torch.profiler``'s timeline around any call,
the host's and, on a card, the device's (CUDA activity through CUPTI), and
writes it into ``dir`` as a Chrome trace (``chrome://tracing``, Perfetto,
TensorBoard's trace viewer); ``annotate`` names a region inside it;
``timed`` wall-clocks a region into a sink or the log.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Any, Iterator

import torch

logger = logging.getLogger("lotus_tpu_torch")


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Record the block with ``torch.profiler`` (CPU activity, plus CUDA
    activity when a card is present) and write
    ``log_dir/trace_<pid>_<ns>.json``.  The card is synchronised before the
    recording stops, so work the block queued is in the trace."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    logger.info(f"profiling: trace written to {path}")


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Name a region inside an active trace (``record_function``; on a card
    also an NVTX range, which ``nsys`` shows)."""
    cuda = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if cuda:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if cuda:
                torch.cuda.nvtx.range_pop()


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
