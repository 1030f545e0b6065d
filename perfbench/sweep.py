#!/usr/bin/env python3
"""The rate sweep of ``c4_ivf10m.served_single``: one shard server, one
window a rate, each rate's latency and whether its backlog grew (the last
quarter's median latency over the first quarter's).  The cell runs at a
fixed rate below the highest one that holds; this finds that rate once.

    python3 perfbench/sweep.py --seed <n> --seconds <s> --rates <r> [<r> ...]
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from perfbench import harness  # noqa: E402
from perfbench.run import Context  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args()
    import torch

    name = "c4_ivf10m.served_single"
    _, cell, config = harness.cell_files(name)
    tmp = tempfile.mkdtemp(prefix="perfbench_sweep_")
    impl = None
    try:
        ctx = Context(cell, config, args.seed, torch.device("cuda"), tmp,
                      harness.Tracer(False, 0.0, 0.0, tmp))
        impl = harness.adapter(cell["adapter"]).Cell(ctx)
        impl.setup()
        for rate in args.rates:
            impl.rate = rate
            out = impl.window(args.seconds)
            lat = out["records"]["latency_ms"]
            q = max(1, len(lat) // 4)
            print(json.dumps({
                "rate_per_s": rate, "requests": out["attempted"], "failed": out["failed"],
                "completed_per_s": (out["attempted"] - out["failed"]) / out["window_s"],
                "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
                "p99_ms": float(np.percentile(lat, 99)),
                "growth": float(np.median(lat[-q:]) / np.median(lat[:q])),
                "late_p95_ms": float(np.percentile(out["records"]["late_ms"], 95)),
                "outside_store_pct": 100 * (1 - out["records"]["served"]["store_sum_s"]
                                            / out["records"]["served"]["latency_sum_s"])}), flush=True)
        impl.release()
    finally:
        if impl is not None:
            impl.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
