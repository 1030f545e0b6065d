"""Config 4's search step's share of its roofline: the least time a batch
needs, whatever implements it (the mean over the traced stretch's batches),
times the batches of the window before the stretch, over that part's
seconds (the profiler not yet started).  A batch reads each list it probes
once (int8 rows and their scales), its f32 queries, the centroids and its
rescored rows (int8, int4 refinement, two scales) at HBM's rate, and does
2 * d int8 operations for each (query, row of a probed list) pair, with
lists of the mean size, at the int8 rate; its least time is the larger of
the two.
"""

import torch

from perfbench import bounds


def _ivf_least(rec: dict) -> float | None:
    """The mean least seconds of a batch over the recorded K1 launches."""
    cfg, b = rec["cfg"], rec["batch"]
    d = cfg["d"]
    per_batch = -(-b // cfg["query_chunk"])
    launches = rec["k1_launches"]
    total, batches = 0.0, 0
    for lo in range(0, len(launches) - per_batch + 1, per_batch):
        group = launches[lo : lo + per_batch]
        sizes = group[0]["sizes"]
        live = torch.unique(torch.cat([g["chunk_list"][g["chunk_list"] >= 0] for g in group])).long()
        nbytes = (float(sizes[live].double().sum()) * (d + 4) + b * d * 4 + cfg["nlist"] * d * 4
                  + b * cfg["rescore"] * (d + d // 2 + 8))
        ops = 2.0 * b * cfg["nprobe"] * (cfg["n"] / cfg["nlist"]) * d
        total += max(nbytes / bounds.HBM_BYTES_PER_S, ops / bounds.INT8_OPS_PER_S)
        batches += 1
    return total / batches if batches else None


def read(rec: dict) -> float | None:
    pre = (rec.get("trace") or {}).get("pre") or {}
    if not pre.get("steps") or pre["seconds"] <= 0:
        return None
    least = _ivf_least(rec) if rec.get("k1_launches") else None
    return None if least is None else 100.0 * least * pre["steps"] / pre["seconds"]
