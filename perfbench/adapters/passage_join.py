"""DeepSeek-V2-Lite's passage sim join: a closed loop of requests, each a
chunk of fresh left passages taken through ``rm(docs)`` and then
``vs(left_emb, k, ids=<every right row>)``, as ``sem_sim_join`` calls the
store; ``search_qps`` counts the left passages answered a second."""

from __future__ import annotations

import numpy as np
import torch

from perfbench import bounds_moe, harness
from perfbench.adapters import _dsv2
from perfbench.reference import judge


class Cell:
    def __init__(self, ctx):
        self.ctx, self.cfg, self.tr = ctx, ctx.config, ctx.cell["traffic"]

    def setup(self) -> None:
        ctx, tr = self.ctx, self.tr
        self.store = _dsv2.Store(ctx)
        self.pool = _dsv2.left_texts(self.cfg, self.store.vocab, ctx.seed, tr["batch"] * tr["pool_requests"])
        self.left_sample = _dsv2.sample(ctx.seed, tr["batch"] * tr["judged_requests"], tr["judge_docs"], 0)
        self.right_sample = _dsv2.sample(ctx.seed, self.cfg["right_docs"], tr["judge_docs"], 1)
        warm = self.store.rm(self.pool[: tr["batch"]])  # the left path once: every shape a request uses
        self.store.vs(warm, self.cfg["k"], ids=self.store.every)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()

    def counting(self) -> dict:
        """Padded and real tokens and the real tokens' causal (query, key)
        pairs, counted from the attention masks the encoder is given (a
        forward pre-hook, on the device), over the whole window of a traced
        run."""
        rm, rec = self.store.rm, {"padded_tokens": 0}
        sums = torch.zeros(2, dtype=torch.float64, device=rm.device)

        def before(_, args):
            ids, mask = args[:2]
            rec["padded_tokens"] += ids.numel()
            lens = mask.sum(1).double()
            sums.add_(torch.stack([lens.sum(), (lens * (lens + 1) / 2).sum()]))

        self.hook = rm.encoder.register_forward_pre_hook(before)
        rec["_sums"] = sums
        return rec

    def window(self, seconds: float) -> dict:
        tracer, tr, st = self.ctx.tracer, self.tr, self.store
        b, n_pool = tr["batch"], tr["pool_requests"]
        counts = self.counting() if tracer.enabled else None
        self.emb, self.ret_i, self.ret_s = [], [], []
        requests = 0
        t0 = harness.now()
        ends = []
        while (elapsed := harness.now() - t0) < seconds:
            tracer.tick(elapsed, lambda: self.snapshot(counts))
            r = requests % n_pool
            docs = self.pool[r * b : (r + 1) * b]
            with harness.span("bench.rm"):
                emb = st.rm(docs)
            with harness.span("bench.vs_ids"):
                out = st.vs(emb, self.cfg["k"], ids=st.every)
            if requests < tr["judged_requests"]:
                sel = self.left_sample[(self.left_sample >= r * b) & (self.left_sample < (r + 1) * b)] - r * b
                self.emb.append(emb[sel])
                self.ret_i.append(np.asarray(out.indices, dtype=np.int64)[sel])
                self.ret_s.append(np.asarray(out.distances, dtype=np.float64)[sel])
            requests += 1
            ends.append(harness.now() - t0)
            tracer.step()
        window_s = harness.now() - t0
        tracer.stop()
        self.served = min(requests, tr["judged_requests"]) * b
        if counts is not None:
            self.hook.remove()
        return {"attempted": requests * b, "failed": 0, "window_s": window_s, "ends": ends,
                "end_to_end": {"search_qps": requests * b / window_s},
                "records": {"model": self.cfg}}

    def snapshot(self, counts: dict) -> dict:
        """The counters so far: padded and real tokens, and the model's
        operations over the real tokens (``bounds_moe.dsv2_flops``)."""
        real, pairs = (float(x) for x in counts["_sums"].cpu())
        return {"padded_tokens": counts["padded_tokens"], "real_tokens": real,
                "model_flops": bounds_moe.dsv2_flops(self.cfg, real, pairs)}

    def memory_peak(self) -> int:
        return torch.cuda.max_memory_allocated()

    def release(self) -> None:
        keep = self.left_sample[self.left_sample < self.served]
        self.left_docs = [self.pool[i] for i in keep]
        self.right_docs = [self.store.right[i] for i in self.right_sample]
        self.right_emb = self.store.right_emb
        self.emb, self.ret_i, self.ret_s = (np.concatenate(x) for x in (self.emb, self.ret_i, self.ret_s))
        self.store.close()
        del self.pool

    def judge(self) -> list[dict]:
        """``emb_gap``: the RM's embeddings of the sampled left passages (from
        the window) and right ones (from set-up) against the reference's;
        ``join_gap``: the returned ids and scores of the sampled left passages
        against an exact search of the RM's own left embeddings over its right
        ones, the store's error alone."""
        ctx, lim = self.ctx, self.cfg["limits"]
        ref_emb = _dsv2.reference_embeddings(self.cfg, ctx.seed, ctx.device, self.left_docs + self.right_docs)
        emb = np.concatenate([self.emb, self.right_emb[self.right_sample]])
        join_gap = judge.join_gap(self.ret_i, self.ret_s, self.emb, self.right_emb, ctx.device)
        return [judge.check("emb_gap", judge.emb_gap(emb, ref_emb), lim["emb_gap"], "max"),
                judge.check("join_gap", join_gap, lim["join_gap"], "max")]

    def judged_metrics(self) -> dict:
        return {}

    def close(self) -> None:
        pass
