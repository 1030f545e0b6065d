"""DeepSeek-V3.2-Exp's whole-document sim join: the passage join's closed
loop (``passage_join.Cell``: each request fresh documents taken through
``rm(docs)``, here one forward of 1 x 32,768 tokens, and then
``vs(left_emb, k, ids=<every right row>)``, as ``sem_sim_join`` calls the
store; ``search_qps`` counts the left documents answered a second) over
DeepSeek-V3.2's model, operations and reference.  The judged requests also
keep layer 0's selection and attention output at sampled query rows past
the indexer's ``index_topk`` (``_dsv32.Probe``), held to the reference's
(``index_agree``, ``attn_gap``) beside ``emb_gap`` and ``join_gap``."""

from __future__ import annotations

import numpy as np
import torch

from perfbench import bounds_dsa, harness
from perfbench.adapters import _dsv32
from perfbench.reference import judge


class Cell(harness.adapter("passage_join").Cell):
    def setup(self) -> None:
        ctx, tr = self.ctx, self.tr
        self.store = _dsv32.Store(ctx)
        self.pool = _dsv32.left_texts(self.cfg, self.store.vocab, ctx.seed, tr["batch"] * tr["pool_requests"])
        judged = tr["batch"] * tr["judged_requests"]
        self.left_sample = np.arange(judged)
        self.right_sample = _dsv32.sample(ctx.seed, self.cfg["right_docs"], tr["judge_docs"] - judged, 1)
        self.rows = _dsv32.probe_rows(ctx.seed, tr["probe_rows"], tr["probe_span"])
        warm = self.store.rm(self.pool[: tr["batch"]])  # the left path once: every shape a request uses
        self.store.vs(warm, self.cfg["k"], ids=self.store.every)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()

    def window(self, seconds: float) -> dict:
        self.probe = _dsv32.Probe(self.store.model, self.rows, self.tr["judged_requests"])
        return super().window(seconds)

    def counting(self) -> dict:
        """Padded and real tokens, the real tokens' causal (query, key) pairs
        and their selected pairs (sum over a text's tokens of min(index_topk,
        t + 1)), counted from the attention masks the encoder is given (a
        forward pre-hook, on the device), over the whole window of a traced
        run."""
        rm, rec = self.store.rm, {"padded_tokens": 0}
        sums = torch.zeros(3, dtype=torch.float64, device=rm.device)
        k = float(self.cfg["index_topk"])

        def before(_, args):
            ids, mask = args[:2]
            rec["padded_tokens"] += ids.numel()
            n = mask.sum(1).double()
            selected = torch.where(n <= k, n * (n + 1) / 2, k * (k + 1) / 2 + (n - k) * k)
            sums.add_(torch.stack([n.sum(), (n * (n + 1) / 2).sum(), selected.sum()]))

        self.hook = rm.encoder.register_forward_pre_hook(before)
        rec["_sums"] = sums
        return rec

    def snapshot(self, counts: dict) -> dict:
        """The counters so far: padded and real tokens, and the model's
        operations over the real tokens (``bounds_dsa.dsv32_flops``)."""
        real, scored, selected = (float(x) for x in counts["_sums"].cpu())
        return {"padded_tokens": counts["padded_tokens"], "real_tokens": real,
                "model_flops": bounds_dsa.dsv32_flops(self.cfg, real, scored, selected)}

    def release(self) -> None:
        self.probe.remove()
        super().release()

    def judge(self) -> list[dict]:
        """``emb_gap`` and ``join_gap`` as the passage join's, against
        DeepSeek-V3.2's reference; ``index_agree`` and ``attn_gap`` over the
        judged documents' probed rows of layer 0."""
        ctx, lim = self.ctx, self.cfg["limits"]
        docs = self.left_docs + self.right_docs
        probe = [self.rows] * len(self.left_docs) + [None] * len(self.right_docs)
        ref_emb, probed = _dsv32.reference_run(self.cfg, ctx.seed, ctx.device, docs, probe)
        emb = np.concatenate([self.emb, self.right_emb[self.right_sample]])
        join_gap = judge.join_gap(self.ret_i, self.ret_s, self.emb, self.right_emb, ctx.device)
        agree, attn_gap = _dsv32.probe_gaps(self.probe.selections, self.probe.outputs, probed)
        if len(self.probe.selections) < len(self.left_docs):
            agree, attn_gap = 0.0, float("inf")  # a judged request left no probe
        return [judge.check("emb_gap", judge.emb_gap(emb, ref_emb), lim["emb_gap"], "max"),
                judge.check("join_gap", join_gap, lim["join_gap"], "max"),
                judge.check("index_agree", agree, lim["index_agree"], "min"),
                judge.check("attn_gap", attn_gap, lim["attn_gap"], "max")]
