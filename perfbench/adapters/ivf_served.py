"""Config 4 as served single queries: an open loop of B-1 requests with
Poisson arrivals at a fixed rate, through ``SearchFrontEnd`` to a
``ShardServer`` in a child process (``ivf_served_child.py``) that serves
the store through the same ``ivf_search_grouped_probe`` call as the bulk
cell.  Each request's latency runs from when it was due."""

from __future__ import annotations

import json
import queue
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import harness
from perfbench.adapters import _ivf
from perfbench.reference import judge

CHILD = [sys.executable, str(Path(__file__).resolve().parent / "ivf_served_child.py")]


def arrival_gaps(rate: float, n: int, seed: int) -> np.ndarray:
    """``n`` Poisson gaps at ``rate``: the same set for every seed (the
    exponential's quantiles at (i + 1/2) / n), in a seeded order."""
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    return _ivf.sample_seed(seed, 2).permutation(gaps)


class Cell:
    IN_PROCESS = False  # the store lives in the child: this process stays off the card until the judge

    def __init__(self, ctx):
        self.ctx, self.cfg, self.tr = ctx, ctx.config, ctx.cell["traffic"]
        self.rate = float(self.tr["rate_per_s"])
        self.child, self.log = None, None

    def setup(self) -> None:
        from lotus_tpu_torch.serving import SearchFrontEnd

        ctx, tr = self.ctx, self.tr
        tmp = Path(ctx.tmp_dir)
        spec = {"config": self.cfg, "traffic": tr, "seed": ctx.seed, "device": str(ctx.device),
                "tmp_dir": ctx.tmp_dir, "trace": ctx.tracer.enabled}
        (tmp / "spec.json").write_text(json.dumps(spec))
        self.log = open(tmp / "child.log", "w")
        self.child = subprocess.Popen([*CHILD, str(tmp / "spec.json")], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                      stderr=self.log, text=True)
        ready = self.ask(None)
        self.pool = np.load(tmp / "pool.npy")
        addr = tuple(ready["address"])
        self.front = [SearchFrontEnd([addr], timeout=tr["timeout_s"]) for _ in range(tr["connections"])]
        for j, fe in enumerate(self.front):
            fe.search(self.pool[j : j + 1], self.cfg["k"])

    def send(self, cmd: str) -> None:
        self.child.stdin.write(cmd + "\n")
        self.child.stdin.flush()

    def ask(self, cmd: str | None) -> dict:
        if cmd is not None:
            self.send(cmd)
        line = self.child.stdout.readline()
        if not line:
            self.child.wait()
            raise RuntimeError(f"the shard server exited ({self.child.returncode}); see its log:\n"
                               + Path(self.ctx.tmp_dir, "child.log").read_text()[-4000:])
        return json.loads(line)

    def window(self, seconds: float) -> dict:
        tracer, tr, k = self.ctx.tracer, self.tr, self.cfg["k"]
        n = int(self.rate * seconds * 1.25) + 16
        due = np.cumsum(arrival_gaps(self.rate, n, self.ctx.seed))
        n = int(np.searchsorted(due, seconds))
        sample = set(_ivf.sample_seed(self.ctx.seed, 1).choice(min(n, len(self.pool)),
                                                                min(tr["judge_queries"], n), replace=False).tolist())
        lat = np.full(n, np.nan)
        late = np.zeros(n)
        answers: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        tasks: queue.Queue = queue.Queue()
        failed = [0]

        def worker(fe):
            while (task := tasks.get()) is not None:
                i, t_due = task
                late[i] = harness.now() - t_due
                try:
                    d, ids = fe.search(self.pool[i % len(self.pool)][None], k)
                    lat[i] = harness.now() - t_due
                    if i in sample:
                        answers[i] = (d[0], ids[0])
                except Exception:  # a request that fails counts as missing
                    failed[0] += 1

        threads = [threading.Thread(target=worker, args=(fe,), daemon=True) for fe in self.front]
        for t in threads:
            t.start()
        before = self.ask("stats")
        t0 = harness.now()
        # The stretch is traced in the child, where the store runs; the
        # commands are sent without waiting, and their replies read after
        # the window.  ``stretch``: when it started, then when it stopped.
        stretch: list[float] = []
        for i in range(n):
            wait = t0 + due[i] - harness.now()
            if wait > 0:
                time.sleep(wait)
            if tracer.enabled and len(stretch) < 2:
                if not stretch and harness.now() - t0 >= tracer.start_s:
                    self.send("trace_start")
                    stretch.append(harness.now() - t0)
                elif stretch and harness.now() - t0 - stretch[0] >= tracer.length_s:
                    self.send("trace_stop")
                    stretch.append(harness.now() - t0)
            tasks.put((i, t0 + due[i]))
        for _ in threads:
            tasks.put(None)
        for t in threads:
            t.join()
        window_s = harness.now() - t0
        if len(stretch) == 1:
            self.send("trace_stop")
        trace, cut = None, n
        if stretch:
            at_start = self.ask(None)
            trace = json.loads(Path(self.ask("trace_done")["summary"]).read_text())
            # The serving tier's share is read over the requests due before
            # the stretch, the profiler not yet started.
            cut = int(np.searchsorted(due, stretch[0]))
        after = at_start if stretch else self.ask("stats")
        done = ~np.isnan(lat)
        # A failed request is missing: it counts as late as the window is long.
        lat_all = np.where(done, lat, window_s)
        self.answers = answers
        late_ms = 1e3 * late[done] if done.any() else np.zeros(1)
        print(f"load generator: {n} requests at {self.rate} /s over {window_s:.3f} s, {failed[0]} failed; sent late "
              f"by p50 {np.percentile(late_ms, 50):.3f} ms, p95 {np.percentile(late_ms, 95):.3f} ms, "
              f"max {late_ms.max():.3f} ms", file=sys.stderr)
        return {"attempted": n, "failed": int(n - done.sum()), "window_s": window_s, "trace": trace,
                "end_to_end": {"latency_p95_ms": 1e3 * float(np.percentile(lat_all, 95))},
                "records": {"served": {"latency_sum_s": float(lat_all[:cut].sum()),
                                       "store_sum_s": after["store_s"] - before["store_s"]},
                            "latency_ms": 1e3 * lat_all, "late_ms": late_ms}}

    def memory_peak(self) -> int:
        """The child's peak: it answers the sampled queries through the
        store call itself, hands over the checked rows as stored and its
        peak, and exits."""
        rows = np.array(sorted(self.answers), dtype=np.int64)
        path = str(Path(self.ctx.tmp_dir) / "judged.npy")
        np.save(path, rows % len(self.pool))
        self.ask(f"finish {path}")
        self.child.stdin.close()
        self.child.wait()
        got = np.load(path + ".npz")
        self.peak = int(got["peak"])
        self.direct = (got["d"], got["i"])
        self.stored = torch.from_numpy(got["stored"]).to(self.ctx.device)
        self.rows = rows
        for fe in self.front:
            fe.close()
        return self.peak

    def release(self) -> None:
        if self.child.returncode is None:
            self.memory_peak()

    def judge(self) -> list[dict]:
        q = self.pool[self.rows % len(self.pool)]
        ret_s = np.stack([self.answers[i][0] for i in self.rows]) if len(self.rows) else np.zeros((0, self.cfg["k"]))
        ret_i = np.stack([self.answers[i][1] for i in self.rows]) if len(self.rows) else np.zeros((0, self.cfg["k"]))
        d, i = self.direct
        differ = [(not np.array_equal(ret_s[j], d[j])) or set(ret_i[j].tolist()) != set(i[j].tolist())
                  for j in range(len(self.rows))]
        checks = _ivf.judge_store(self.cfg, self.ctx.seed, self.ctx.device, q, ret_i.astype(np.int64), ret_s,
                                  self.stored)
        self.recall = checks[0]["value"]
        return [*checks, judge.check("served_mismatch", float(sum(differ)), 0.0, "max")]

    def judged_metrics(self) -> dict:
        return {"recall_at_10": self.recall}

    def close(self) -> None:
        if self.child is not None and self.child.poll() is None:
            self.child.kill()
            self.child.wait()
        if self.log is not None:
            self.log.close()
