"""Config 4 in bulk: a closed loop of query batches through
``ivf_search_grouped_probe``, each batch host -> device and its ids and
scores back to the host, as a bulk operator needs them."""

from __future__ import annotations

import numpy as np
import torch

from perfbench import corpus, harness
from perfbench.adapters import _ivf


class Cell:
    def __init__(self, ctx):
        self.ctx, self.cfg, self.tr = ctx, ctx.config, ctx.cell["traffic"]
        self.k1_launches: list[dict] = []

    def setup(self) -> None:
        from lotus_tpu_torch.ops.ivf_probe import probe_fold

        self.probe_fold = probe_fold
        ctx, cfg, tr = self.ctx, self.cfg, self.tr
        self.state = _ivf.build_store(cfg, ctx.seed, ctx.device)
        b, n_pool = tr["batch"], tr["pool_batches"]
        self.pool = corpus.sample_queries(ctx.seed, cfg, b * n_pool, ctx.device).cpu().numpy().reshape(n_pool, b, -1)
        self.search = _ivf.search_fn(cfg)
        rng = _ivf.sample_seed(ctx.seed, 1)
        self.sample = np.sort(rng.choice(b * n_pool, tr["judge_queries"], replace=False))
        for i in range(tr["warmup_batches"]):
            self.call(self.pool[i % n_pool])
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()

    def fold(self, *args, **kw):
        """K1 as the program launches it, its inputs' sizes recorded for the
        roofline while the stretch is traced."""
        if self.ctx.tracer.active:
            xq_units, xb, chunk_list, sizes = args[0], args[1], args[4], args[6]
            self.k1_launches.append({
                "chunk_list": chunk_list.clone(), "sizes": sizes, "d": xb.shape[1], "row_elem": xb.element_size(),
                "unit_elem": xq_units.element_size(), "int8_rows": xb.dtype == torch.int8,
                "int8_dot": kw["int8_dot"], "packed": kw["packed"], "top1": kw.get("top1", False)})
        return self.probe_fold(*args, **kw)

    def call(self, xq_np: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        with harness.span("bench.queries_to_device"):
            xq = torch.from_numpy(xq_np).to(self.ctx.device)
        with harness.span("bench.grouped_probe"):
            d, i = self.search(self.state, xq, fold=self.fold)
        with harness.span("bench.results_to_host"):
            return d.cpu().numpy(), i.cpu().numpy()

    def window(self, seconds: float) -> dict:
        tracer, tr = self.ctx.tracer, self.tr
        b, n_pool = tr["batch"], tr["pool_batches"]
        self.ret_s = np.zeros((len(self.sample), self.cfg["k"]), np.float32)
        self.ret_i = np.full((len(self.sample), self.cfg["k"]), -1, np.int64)
        batches = 0
        t0 = harness.now()
        ends = []
        while (elapsed := harness.now() - t0) < seconds:
            tracer.tick(elapsed, lambda: {"steps": batches})
            p = batches % n_pool
            d, i = self.call(self.pool[p])
            if batches < n_pool:
                sel = (self.sample >= p * b) & (self.sample < (p + 1) * b)
                self.ret_s[sel], self.ret_i[sel] = d[self.sample[sel] - p * b], i[self.sample[sel] - p * b]
            batches += 1
            ends.append(harness.now() - t0)
            tracer.step()
        window_s = harness.now() - t0
        tracer.stop()
        self.served = min(batches, n_pool) * b
        return {"attempted": batches * b, "failed": 0, "window_s": window_s, "ends": ends,
                "end_to_end": {"search_qps": batches * b / window_s},
                "records": {"k1_launches": self.k1_launches, "batch": b, "cfg": self.cfg}}

    def memory_peak(self) -> int:
        return torch.cuda.max_memory_allocated()

    def release(self) -> None:
        """Keeps what the judge reads of the program's output (the sampled
        answers and the checked rows as stored) and frees the store."""
        keep = self.sample < self.served
        self.q_np = self.pool.reshape(-1, self.pool.shape[-1])[self.sample[keep]]
        self.ret_s, self.ret_i = self.ret_s[keep], self.ret_i[keep]
        self.stored = _ivf.store_rows(self.state, _ivf.build_check_rows(self.cfg, self.ctx.seed, self.ctx.device))
        del self.state, self.pool, self.k1_launches

    def judge(self) -> list[dict]:
        checks = _ivf.judge_store(self.cfg, self.ctx.seed, self.ctx.device, self.q_np, self.ret_i, self.ret_s,
                                  self.stored)
        self.recall = checks[0]["value"]
        return checks

    def judged_metrics(self) -> dict:
        return {"recall_at_10": self.recall}

    def close(self) -> None:
        pass
