#!/usr/bin/env python3
"""The control of a cell: the plain reference put in the program's place,
one precision below the configuration's, judged by the same numbers and
limits as the program.  It has to come out not correct.

    python3 perfbench/control.py --workload <cell> --seeds <n> [<n> ...]

Config 4's control searches the corpus's rows rounded to int4 exactly and
holds them as its store; e5-base-v2's embeds every text with the reference's
forward, each linear layer's inputs and weights rounded to fp8 (e4m3), and
searches those embeddings exactly.  The benchmark's own runs never run it.
Prints one JSON line a seed with each number beside its limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import corpus, harness  # noqa: E402
from perfbench.adapters import _e5, _ivf  # noqa: E402


def ivf_control(cell: dict, cfg: dict, seed: int, device) -> list[dict]:
    tr = cell["traffic"]
    n = tr["batch"] * tr["pool_batches"] if "batch" in tr else tr["pool"]
    pool = corpus.sample_queries(seed, cfg, n, device).cpu().numpy()
    rows = _ivf.sample_seed(seed, 1).choice(n, min(tr["judge_queries"], n), replace=False)
    return _ivf.control_numbers(cfg, seed, device, pool[rows])


def e5_control(cell: dict, cfg: dict, seed: int, device) -> list[dict]:
    import numpy as np

    from perfbench import texts

    tr = cell["traffic"]
    vocab = texts.make_vocab(_e5.sub_seed(seed, "vocab"), cfg["model"]["vocab_size"])
    n = tr["batch"] * (tr.get("pool_batches") or tr["judged_requests"])
    docs = _e5.left_texts(cfg, vocab, seed, n)
    rng = np.random.default_rng(_e5.sub_seed(seed, "sample"))
    pick = np.sort(rng.choice(n, tr["judge_docs"], replace=False))
    docs = [docs[i] for i in pick]
    left, right = _e5.reference_embeddings(cfg, seed, device, docs)
    c_left, c_right = _e5.reference_embeddings(cfg, seed, device, docs, fp8=True)
    ids, scores = _e5.control_answers(cfg, c_left, c_right, device)
    emb = c_left if cell["adapter"] == "text_join" else None
    return _e5.judge_join(cfg, ids, scores, left, right, emb, device)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    import torch

    _, cell, cfg = harness.cell_files(args.workload)
    device = torch.device("cuda")
    for seed in args.seeds:
        fn = ivf_control if cell["adapter"] in ("ivf_bulk", "ivf_served") else e5_control
        checks = fn(cell, cfg, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": all(c["ok"] for c in checks),
                          "checks": {c["name"]: [harness.finite(c["value"]), c["limit"]] for c in checks}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
