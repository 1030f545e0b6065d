#!/usr/bin/env python3
"""The control of the DeepSeek-V3.2 cell: the plain reference with every
linear layer's inputs and weights rounded per row to fp8 e4m3 (the
indexer's projections, the router and the experts included), one precision
below the configuration's bf16, put in the program's place and judged by the
cell's numbers and limits.  It has to come out not correct.

    python3 perfbench/control_dsv32.py --workload dsv32_exp.doc32k_join --seeds <n> [<n> ...]

For each seed it runs the documents the cell would judge (the left
documents of the window's judged requests and the sampled right ones)
through the control and through the f32 reference: ``emb_gap`` is the
control's embeddings against the reference's; ``join_gap`` the control's
exact top-k of its left embeddings over its sampled right ones, against the
reference's embeddings of the same documents; ``index_agree`` and
``attn_gap`` the control's layer-0 selection and attention output at the
probed rows against the reference's.  The benchmark's own runs never run
it.  Prints one JSON line a seed with each number beside its limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness, texts  # noqa: E402
from perfbench.adapters import _dsv32  # noqa: E402
from perfbench.reference import judge  # noqa: E402


def control_checks(cell: dict, cfg: dict, seed: int, device) -> list[dict]:
    import torch

    tr = cell["traffic"]
    vocab = _dsv32.word_list(seed)
    judged = tr["batch"] * tr["judged_requests"]
    left = _dsv32.left_texts(cfg, vocab, seed, judged)
    right = texts.synth_texts(vocab, cfg["right_docs"], *cfg["words"], _dsv32.sub_seed(seed, "right"), cfg["k"])
    right = [right[i] for i in _dsv32.sample(seed, cfg["right_docs"], tr["judge_docs"] - judged, 1)]
    rows = _dsv32.probe_rows(seed, tr["probe_rows"], tr["probe_span"])
    probe = [rows] * len(left) + [None] * len(right)
    exact, exact_probed = _dsv32.reference_run(cfg, seed, device, left + right, probe)
    fp8, fp8_probed = _dsv32.reference_run(cfg, seed, device, left + right, probe, fp8=True)
    n, k = len(left), min(cfg["k"], len(right))
    c_left, c_right = (torch.from_numpy(x).to(device, torch.float64) for x in (fp8[:n], fp8[n:]))
    scores, ids = torch.topk(c_left @ c_right.T, k, dim=1)
    agree, attn_gap = _dsv32.probe_gaps([s for s, _ in fp8_probed], [o for _, o in fp8_probed], exact_probed)
    lim = cfg["limits"]
    return [judge.check("emb_gap", judge.emb_gap(fp8, exact), lim["emb_gap"], "max"),
            judge.check("join_gap", judge.join_gap(ids.cpu().numpy(), scores.cpu().numpy(), exact[:n], exact[n:],
                                                   device), lim["join_gap"], "max"),
            judge.check("index_agree", agree, lim["index_agree"], "min"),
            judge.check("attn_gap", attn_gap, lim["attn_gap"], "max")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="dsv32_exp.doc32k_join")
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
