"""Kimi-Linear's long-document sim join: the passage join's closed loop
(``passage_join.Cell``: each request a batch of fresh documents taken
through ``rm(docs)``, here one forward of ``batch`` x 8,192 tokens, and then
``vs(left_emb, k, ids=<every right row>)``, as ``sem_sim_join`` calls the
store; ``search_qps`` counts the left documents answered a second) over
Kimi-Linear's model, operations and reference."""

from __future__ import annotations

import numpy as np
import torch

from perfbench import bounds_kda, harness
from perfbench.adapters import _kimi
from perfbench.reference import judge


class Cell(harness.adapter("passage_join").Cell):
    def setup(self) -> None:
        ctx, tr = self.ctx, self.tr
        self.store = _kimi.Store(ctx)
        self.pool = _kimi.left_texts(self.cfg, self.store.vocab, ctx.seed, tr["batch"] * tr["pool_requests"])
        self.left_sample = _kimi.sample(ctx.seed, tr["batch"] * tr["judged_requests"], tr["judge_docs"], 0)
        self.right_sample = _kimi.sample(ctx.seed, self.cfg["right_docs"], tr["judge_docs"], 1)
        warm = self.store.rm(self.pool[: tr["batch"]])  # the left path once: every shape a request uses
        self.store.vs(warm, self.cfg["k"], ids=self.store.every)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()

    def snapshot(self, counts: dict) -> dict:
        """The counters so far: padded and real tokens, and the model's
        operations over the real tokens (``bounds_kda.kimi_flops``)."""
        real, pairs = (float(x) for x in counts["_sums"].cpu())
        return {"padded_tokens": counts["padded_tokens"], "real_tokens": real,
                "model_flops": bounds_kda.kimi_flops(self.cfg, real, pairs)}

    def judge(self) -> list[dict]:
        """``emb_gap`` and ``join_gap`` as the passage join's, against
        Kimi-Linear's reference."""
        ctx, lim = self.ctx, self.cfg["limits"]
        ref_emb = _kimi.reference_embeddings(self.cfg, ctx.seed, ctx.device, self.left_docs + self.right_docs)
        emb = np.concatenate([self.emb, self.right_emb[self.right_sample]])
        join_gap = judge.join_gap(self.ret_i, self.ret_s, self.emb, self.right_emb, ctx.device)
        return [judge.check("emb_gap", judge.emb_gap(emb, ref_emb), lim["emb_gap"], "max"),
                judge.check("join_gap", join_gap, lim["join_gap"], "max")]
