"""e5-base-v2's sim join from text: a closed loop of requests, each a chunk
of fresh left documents taken through ``rm(docs)`` and then
``vs(left_emb, k, ids=<every right row>)``, as ``sem_sim_join`` calls the
store."""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import bounds, harness
from perfbench.adapters import _e5


class Cell:
    def __init__(self, ctx):
        self.ctx, self.cfg, self.tr = ctx, ctx.config, ctx.cell["traffic"]

    def setup(self) -> None:
        ctx, tr = self.ctx, self.tr
        self.store = _e5.Store(ctx)
        self.pool = _e5.left_texts(self.cfg, self.store.vocab, ctx.seed, tr["batch"] * tr["pool_requests"])
        rng = np.random.default_rng(_e5.sub_seed(ctx.seed, "sample"))
        self.sample = np.sort(rng.choice(tr["batch"] * tr["judged_requests"], tr["judge_docs"], replace=False))
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()

    def counting(self) -> dict:
        """The tokenizer's host seconds (``tokenizer.encode`` wrapped, as
        ``chip_smoke.py::encode_split`` wraps it) and the encoder's real and
        padded tokens and model operations (a forward pre-hook), over the
        whole window of a traced run."""
        rm, rec = self.store.rm, {"tokenize_s": 0.0, "padded_tokens": 0}
        sums = torch.zeros(2, dtype=torch.float64, device=rm.device)
        encode = rm.tokenizer.encode

        def counted_encode(*args, **kw):
            t0 = time.perf_counter()
            out = encode(*args, **kw)
            rec["tokenize_s"] += time.perf_counter() - t0
            return out

        def before(_, args):
            ids, mask = args[:2]
            rec["padded_tokens"] += ids.numel()
            lens = mask.sum(1).double()
            sums.add_(torch.stack([lens.sum(), (lens * lens).sum()]))

        rm.tokenizer.encode = counted_encode
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
                sel = self.sample[(self.sample >= r * b) & (self.sample < (r + 1) * b)] - r * b
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
            del st.rm.tokenizer.encode
            self.hook.remove()
        return {"attempted": requests * b, "failed": 0, "window_s": window_s, "ends": ends,
                "end_to_end": {"text_docs_per_s": requests * b / window_s}}

    def snapshot(self, counts: dict) -> dict:
        """The counters so far: the tokenizer's seconds, real and padded
        tokens, and the encoder's model operations over the real tokens."""
        real, sum_sq = (float(x) for x in counts["_sums"].cpu())
        return {"tokenize_s": counts["tokenize_s"], "padded_tokens": counts["padded_tokens"], "real_tokens": real,
                "model_flops": bounds.bert_flops(self.cfg["model"], real, sum_sq)}

    def memory_peak(self) -> int:
        return torch.cuda.max_memory_allocated()

    def release(self) -> None:
        keep = self.sample[self.sample < self.served]
        self.docs = [self.pool[i] for i in keep]
        self.emb, self.ret_i, self.ret_s = (np.concatenate(x) for x in (self.emb, self.ret_i, self.ret_s))
        self.store.close()
        del self.pool

    def judge(self) -> list[dict]:
        left, right = _e5.reference_embeddings(self.cfg, self.ctx.seed, self.ctx.device, self.docs)
        return _e5.judge_join(self.cfg, self.ret_i, self.ret_s, left, right, self.emb, self.ctx.device)

    def judged_metrics(self) -> dict:
        return {}

    def close(self) -> None:
        pass
