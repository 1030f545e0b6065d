#!/usr/bin/env python3
"""The shard server of ``c4_ivf10m.served_single``: builds config 4's store
from the seed, serves it with ``lotus_tpu_torch.serving.ShardServer`` on an
ephemeral loopback port, and answers the parent's commands on stdin, one
JSON line each on stdout:

- ``stats``: the store calls so far and their seconds;
- ``trace_start`` / ``trace_stop``: the traced stretch's span, in a
  profiler that runs from the end of set-up (``--trace 1``);
  ``trace_start`` replies with the stats before it;
- ``trace_done``: the profiler stopped and its trace reduced (after the
  window); replies with the file the reduction was written to;
- ``finish <path>``: the store's own answers to the pool queries listed in
  ``<path>``, the checked rows as stored and the card's peak, into
  ``<path>.npz``; then the server stops and the process exits.

    python3 perfbench/adapters/ivf_served_child.py <spec.json>
"""

from __future__ import annotations

import json
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))


def reply(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def serve(spec: dict) -> None:
    import numpy as np
    import torch

    from lotus_tpu_torch.serving import ShardServer
    from perfbench import corpus, harness
    from perfbench.adapters import _ivf

    cfg, tr, seed = spec["config"], spec["traffic"], spec["seed"]
    dev = torch.device(spec["device"])
    state = _ivf.build_store(cfg, seed, dev)
    pool = corpus.sample_queries(seed, cfg, tr["pool"], dev).cpu().numpy()
    np.save(Path(spec["tmp_dir"]) / "pool.npy", pool)
    search_on_device = _ivf.search_fn(cfg)
    lock = threading.Lock()
    stats = {"calls": 0, "store_s": 0.0}

    def store_call(xq: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        with harness.span("bench.store_call"):
            d, i = search_on_device(state, torch.from_numpy(np.ascontiguousarray(xq)).to(dev))
            return d.cpu().numpy(), i.cpu().numpy().astype(np.int64)

    def search(xq: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        with lock:
            t0 = time.perf_counter()
            out = store_call(xq)
            stats["store_s"] += time.perf_counter() - t0
            stats["calls"] += 1
        return out

    for i in range(tr["warmup_requests"]):
        store_call(pool[i : i + 1])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    tracer = harness.Tracer(spec["trace"], 0.0, 0.0, spec["tmp_dir"])
    if spec["trace"]:
        # Starting the profiler stalls this process for seconds, and a stall
        # inside the window would back the queue up: it runs from here to
        # the window's end, and the stretch is a span inside it.
        tracer.start_profiler()
    server = ShardServer(search).start()
    reply({"ready": True, "address": list(server.address)})
    try:
        for line in sys.stdin:
            cmd, _, arg = line.strip().partition(" ")
            if cmd == "stats":
                with lock:
                    reply(dict(stats))
            elif cmd == "trace_start":
                with lock:
                    reply(dict(stats))
                tracer.begin()
            elif cmd == "trace_stop":
                tracer.end()
            elif cmd == "trace_done":
                tracer._prof.stop()
                tracer.done = True
                path = Path(spec["tmp_dir"]) / "trace_summary.json"
                path.write_text(json.dumps(tracer.finish()))
                reply({"summary": str(path)})
            elif cmd == "finish":
                server.stop()
                rows = np.load(arg)
                # One query a call, as each was served.
                answers = [store_call(pool[r : r + 1]) for r in rows]
                d = np.concatenate([a[0] for a in answers]) if answers else np.zeros((0, cfg["k"]), np.float32)
                i = np.concatenate([a[1] for a in answers]) if answers else np.zeros((0, cfg["k"]), np.int64)
                peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
                stored = _ivf.store_rows(state, _ivf.build_check_rows(cfg, seed, dev)).cpu().numpy()
                np.savez(arg + ".npz", d=d, i=i, stored=stored, peak=np.int64(peak))
                reply({"finished": True})
                return
    finally:
        server.stop()


if __name__ == "__main__":
    serve(json.loads(Path(sys.argv[1]).read_text()))
