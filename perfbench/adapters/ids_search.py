"""The ids search every pandas operator's search takes: a closed loop of
batches of left embeddings (made by the RM in set-up) through
``vs(q, k, ids=<every right row>)``, with no encoder in the loop."""

from __future__ import annotations

import numpy as np
import torch

from perfbench import harness
from perfbench.adapters import _e5


class Cell:
    def __init__(self, ctx):
        self.ctx, self.cfg, self.tr = ctx, ctx.config, ctx.cell["traffic"]

    def setup(self) -> None:
        ctx, tr = self.ctx, self.tr
        self.store = _e5.Store(ctx)
        self.left = _e5.left_texts(self.cfg, self.store.vocab, ctx.seed, tr["batch"] * tr["pool_batches"])
        self.pool = self.store.rm(self.left).reshape(tr["pool_batches"], tr["batch"], -1)
        rng = np.random.default_rng(_e5.sub_seed(ctx.seed, "sample"))
        self.sample = np.sort(rng.choice(len(self.left), tr["judge_docs"], replace=False))
        self.store.vs(self.pool[0], self.cfg["k"], ids=self.store.every)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()

    def window(self, seconds: float) -> dict:
        tracer, tr, st = self.ctx.tracer, self.tr, self.store
        b, n_pool = tr["batch"], tr["pool_batches"]
        self.ret_i = np.full((len(self.sample), self.cfg["k"]), -1, np.int64)
        self.ret_s = np.zeros((len(self.sample), self.cfg["k"]))
        batches = 0
        t0 = harness.now()
        ends = []
        while (elapsed := harness.now() - t0) < seconds:
            tracer.tick(elapsed, lambda: {"steps": batches})
            p = batches % n_pool
            with harness.span("bench.vs_ids"):
                out = st.vs(self.pool[p], self.cfg["k"], ids=st.every)
            if batches < n_pool:
                sel = (self.sample >= p * b) & (self.sample < (p + 1) * b)
                self.ret_i[sel] = np.asarray(out.indices, dtype=np.int64)[self.sample[sel] - p * b]
                self.ret_s[sel] = np.asarray(out.distances)[self.sample[sel] - p * b]
            batches += 1
            ends.append(harness.now() - t0)
            tracer.step()
        window_s = harness.now() - t0
        tracer.stop()
        self.served = min(batches, n_pool) * b
        return {"attempted": batches * b, "failed": 0, "window_s": window_s, "ends": ends,
                "end_to_end": {"ids_search_qps": batches * b / window_s},
                "records": {"ids_rows": len(st.every), "batch": b, "d": self.cfg["model"]["hidden_size"]}}

    def memory_peak(self) -> int:
        return torch.cuda.max_memory_allocated()

    def release(self) -> None:
        keep = self.sample < self.served
        self.docs = [self.left[i] for i in self.sample[keep]]
        self.ret_i, self.ret_s = self.ret_i[keep], self.ret_s[keep]
        self.store.close()
        del self.pool, self.left

    def judge(self) -> list[dict]:
        left, right = _e5.reference_embeddings(self.cfg, self.ctx.seed, self.ctx.device, self.docs)
        return _e5.judge_join(self.cfg, self.ret_i, self.ret_s, left, right, None, self.ctx.device)

    def judged_metrics(self) -> dict:
        return {}

    def close(self) -> None:
        pass
