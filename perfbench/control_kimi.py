#!/usr/bin/env python3
"""The control of the Kimi-Linear cell: the plain reference with every
linear layer's inputs and weights rounded per row to fp8 e4m3 (the KDA
projections, the router and the experts included), one precision below the
configuration's bf16, put in the program's place and judged by the cell's
numbers and limits.  It has to come out not correct.

    python3 perfbench/control_kimi.py --workload kimi_linear.long_join --seeds <n> [<n> ...]

For each seed it embeds the documents the cell would judge (the sampled left
documents of the window's first requests and as many sampled right ones)
with the control and with the f32 reference: ``emb_gap`` is the control's
embeddings against the reference's; ``join_gap`` the control's exact top-k
of its left embeddings over its sampled right ones, against the reference's
embeddings of the same documents (re-embedding all 256 right documents twice
would take many minutes).  The benchmark's own runs never run it.  Prints
one JSON line a seed with each number beside its limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness, texts  # noqa: E402
from perfbench.adapters import _kimi  # noqa: E402
from perfbench.reference import judge  # noqa: E402


def control_checks(cell: dict, cfg: dict, seed: int, device) -> list[dict]:
    import torch

    tr = cell["traffic"]
    vocab = _kimi.word_list(seed)
    pool = _kimi.left_texts(cfg, vocab, seed, tr["batch"] * tr["judged_requests"])
    right = texts.synth_texts(vocab, cfg["right_docs"], *cfg["words"], _kimi.sub_seed(seed, "right"), cfg["k"])
    left = [pool[i] for i in _kimi.sample(seed, len(pool), tr["judge_docs"], 0)]
    right = [right[i] for i in _kimi.sample(seed, cfg["right_docs"], tr["judge_docs"], 1)]
    exact = _kimi.reference_embeddings(cfg, seed, device, left + right)
    fp8 = _kimi.reference_embeddings(cfg, seed, device, left + right, fp8=True)
    n, k = len(left), min(cfg["k"], len(right))
    c_left, c_right = (torch.from_numpy(x).to(device, torch.float64) for x in (fp8[:n], fp8[n:]))
    scores, ids = torch.topk(c_left @ c_right.T, k, dim=1)
    lim = cfg["limits"]
    return [judge.check("emb_gap", judge.emb_gap(fp8, exact), lim["emb_gap"], "max"),
            judge.check("join_gap", judge.join_gap(ids.cpu().numpy(), scores.cpu().numpy(), exact[:n], exact[n:],
                                                   device), lim["join_gap"], "max")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="kimi_linear.long_join")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    import torch

    _, cell, cfg = harness.cell_files(args.workload)
    for seed in args.seeds:
        checks = control_checks(cell, cfg, seed, torch.device("cuda"))
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": all(c["ok"] for c in checks),
                          "checks": {c["name"]: [harness.finite(c["value"]), c["limit"]] for c in checks}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
