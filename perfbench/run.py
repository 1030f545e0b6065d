#!/usr/bin/env python3
"""The benchmark of lotus_tpu_torch on NVIDIA GPUs: one cell, run once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads and warms up the cell (its set-up, ``setup_s``), measures for
``--seconds``, checks what the timed path produced against the plain
reference (``perfbench/reference/``), and prints one JSON line: the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics and the trace's
breakdown (``--trace 1``).  See ``perfbench/README.md``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness  # noqa: E402


class Context:
    """What an adapter is given: the cell, its configuration, the seed, the
    device, a scratch directory under ``TMPDIR`` and the tracer."""

    def __init__(self, cell: dict, config: dict, seed: int, device, tmp_dir: str, tracer):
        self.cell, self.config, self.seed = cell, config, seed
        self.device, self.tmp_dir, self.tracer = device, tmp_dir, tracer


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device=None, cell=None, config=None,
             chips: int = 1) -> tuple[dict, list[dict]]:
    """Set up, measure and judge one cell; returns (result, checks).
    ``device`` / ``cell`` / ``config`` override the card and the cell's
    files (the CPU tests rehearse a cell at a tiny size this way)."""
    import torch

    _, cell_file, config_file = harness.cell_files(name)
    cell, config = cell or cell_file, config or config_file
    device = torch.device("cuda" if device is None else device)
    on_card = device.type == "cuda"
    tmp_dir = tempfile.mkdtemp(prefix="perfbench_")
    tracer = harness.Tracer(trace, cell["trace_start_s"], cell["trace_s"], tmp_dir)
    impl = harness.adapter(cell["adapter"]).Cell(Context(cell, config, seed, device, tmp_dir, tracer))
    try:
        impl.setup()
        in_process = getattr(impl, "IN_PROCESS", True)
        setup_s = time.perf_counter() - T_START
        if on_card and in_process:
            torch.cuda.reset_peak_memory_stats()
        out = impl.window(seconds)
        tracer.stop()
        trace_summary = out.get("trace") or tracer.finish()
        found = harness.forbidden_modules()
        if found:
            raise SystemExit(f"the window loaded {found}: the benchmark measures lotus_tpu_torch alone")
        peak = impl.memory_peak() if on_card else 0
        impl.release()
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t_judge = time.perf_counter()
        checks = impl.judge()
        print(f"perfbench: window {out['window_s']:.3f} s, set-up {setup_s:.3f} s, the reference's judge "
              f"{time.perf_counter() - t_judge:.3f} s{harness.spread_of_requests(out.get('ends'))}", file=sys.stderr)
        judged = impl.judged_metrics()
    finally:
        impl.close()  # every process the cell started has ended
        shutil.rmtree(tmp_dir, ignore_errors=True)
    values = {"setup_s": setup_s, **out["end_to_end"], **judged}
    result: dict = {"correct": all(c["ok"] for c in checks), "attempted": out["attempted"], "failed": out["failed"]}
    device_rec = harness.device_info(chips) if on_card else {"platform": "cpu", "kind": "cpu", "count": 0}
    device_rec["memory_peak_bytes"] = int(peak)
    if trace:
        rec = {**out.get("records", {}), "trace": trace_summary}
        metrics = {}
        for m in harness.metrics_of(name, "per_layer"):
            v = harness.read_per_layer(m["name"], rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
        if rec["trace"]:
            device_rec["busy_s"] = rec["trace"]["busy_s"]
            device_rec["window_s"] = rec["trace"]["window_s"]
            result["breakdown"] = harness.breakdown(rec["trace"])
    else:
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in harness.metrics_of(name, "end_to_end")}
    result["device"] = device_rec
    return result, checks


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    harness.fixed_cache_dirs()
    import torch

    entry = harness.cell_files(args.workload)[0]
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"perfbench: {args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    import lotus_tpu_torch

    pkg = Path(lotus_tpu_torch.__file__).resolve()
    if harness.ROOT not in pkg.parents:
        print(f"perfbench: lotus_tpu_torch comes from {pkg}, not from this checkout", file=sys.stderr)
        return 2
    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), chips=entry["chips"])
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: {found} loaded in the measuring process", file=sys.stderr)
        return 3
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
