"""Recall-target autotuning for the IVF probe.

The port's own copy of ``lotus_tpu/ops/autotune.py`` (:1-161): that module
holds no JAX, but importing anything under ``lotus_tpu`` runs its package
``__init__``, which pulls in jax and pandas.  Same functions, same result
dict with the same keys, so a calibration persisted by either package's
store is adopted by the other's.

The reference exposes faiss's raw ``nprobe`` and leaves picking it to the
user (``lotus/vector_store/faiss_vs.py`` never tunes it).  Here the store
calibrates itself: sample stored rows as stand-in queries (the standard
index-autotune proxy when the real query distribution is unknown), rank
them against an oracle, then walk an nprobe ladder and keep the smallest
value whose recall@k meets the target.

Two oracles:

- ``full probe`` (default): ``nprobe = nlist`` on the store's own serving
  path — by construction the best any nprobe can do on this store,
  quantization included.  The measured recall is SELF-RELATIVE: it prices
  the probe's candidate caps but NOT quantization loss vs exact float32.
- ``exact`` (pass ``oracle_indices``): ground truth from an exact float32
  scan of the unquantised corpus.  The measured recall is ABSOLUTE, and
  the full probe's recall vs this oracle is the store's structural
  ceiling — a ``recall_target`` above it is flagged unreachable instead
  of silently rounding down.

Calibration measures every probe path the store will actually serve with
(pass one search fn per serving regime; a ladder point's recall is the
MIN across regimes).  ``TorchVS`` passes exactly its planner's serving
path: the grouped probe (K1) on block-aligned stores, which serve every
batch size through it, the window probe otherwise — and recalibrates on
the window probe when the grouped probe's ceiling is below the target
(regime drop).
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Sequence, Union

import numpy as np

SearchFn = Callable[[np.ndarray, int, int], np.ndarray]


def nprobe_ladder(nlist: int, start: int = 1) -> list[int]:
    """Geometric-ish ladder {1, 2, 3, 4, 6, 8, 12, ...} capped at nlist.

    ~1.5x steps keep the chosen point within ~25% of the true minimal
    nprobe while needing only O(log nlist) measurements.
    """
    out: list[int] = []
    v = max(1, start)
    while v < nlist:
        out.append(v)
        nxt = v + max(1, v // 2)
        v = nxt
    out.append(nlist)
    # dedup, keep order
    seen: set[int] = set()
    return [x for x in out if not (x in seen or seen.add(x))]


def recall_at_k(got: np.ndarray, want: np.ndarray, k: int) -> float:
    """Mean |got ∩ want| / |want| per row (−1 = no-hit padding, never
    matches).  Normalizing by the VALID oracle hits — not by k — keeps
    recall 1.0 reachable when a query has fewer than k true neighbors
    (tiny lists / corpora pad the oracle rows with −1)."""
    total = 0.0
    for g, w in zip(got, want):
        ws = set(int(x) for x in w[:k] if x >= 0)
        gs = set(int(x) for x in g[:k] if x >= 0)
        total += len(gs & ws) / max(len(ws), 1)
    return total / max(len(got), 1)


def calibrate_nprobe(
    search_fn: Union[SearchFn, Mapping[str, SearchFn]],
    xq: np.ndarray,
    *,
    nlist: int,
    recall_target: float,
    k: int = 10,
    ladder: Sequence[int] | None = None,
    oracle_indices: np.ndarray | None = None,
    oracle_regime: str | None = None,
) -> dict[str, Any]:
    """Pick the smallest ladder nprobe whose recall@k meets ``recall_target``.

    Args:
        search_fn: ``(xq, k, nprobe) -> (nq, >=k) int indices`` ranking with
            the store's serving path — or a ``{regime: fn}`` mapping when
            different batch regimes serve through different probe paths.  A
            ladder point's recall is the MIN across regimes, so the chosen
            nprobe meets the target on every serving path.
        oracle_indices: optional ``(nq, >=k)`` EXACT ground-truth indices
            (float32 exhaustive scan).  When given, recall is absolute and
            the result carries the store's structural ceiling (the full
            probe's recall vs this oracle) plus ``target_unreachable`` when
            the ceiling itself is below the target.  Without it, recall is
            self-relative to the full probe.
        oracle_regime: which regime's full probe anchors the relative
            metric (defaults to the first).

    Returns ``{"nprobe", "recall", "recall_rel", "recall_abs", "oracle",
    "ceiling", "target_unreachable", "k", "recall_target",
    "ladder": [(nprobe, recall), ...], "regimes": [...]}``.  If no ladder
    point reaches the target, the full probe (nprobe = nlist) is returned
    with ``target_unreachable`` set when even it falls short.
    """
    if not 0.0 < recall_target <= 1.0:
        raise ValueError(f"recall_target must be in (0, 1], got {recall_target}")
    fns: dict[str, SearchFn] = (
        dict(search_fn) if isinstance(search_fn, Mapping) else {"serve": search_fn}
    )
    if not fns:
        raise ValueError("need at least one search fn")
    anchor = oracle_regime if oracle_regime is not None else next(iter(fns))
    if anchor not in fns:
        raise ValueError(f"oracle_regime {anchor!r} not in regimes {list(fns)}")

    # Full probe per regime: the anchor's defines the relative oracle; the
    # MIN across regimes defines the structural ceiling — what the store can
    # deliver on its WORST serving path with the best possible nprobe.  The
    # paths only guarantee ~0.9 mutual top-k overlap, so a single-regime
    # ceiling would let a worse non-anchor path evade the unreachable flag.
    fulls = {name: np.asarray(fn(xq, k, nlist)) for name, fn in fns.items()}
    full = fulls[anchor]
    exact = oracle_indices is not None
    want = np.asarray(oracle_indices) if exact else full
    ceilings = {name: recall_at_k(f, want, k) for name, f in fulls.items()}
    ceiling = min(ceilings.values())

    points: list[tuple[int, float]] = []
    chosen: tuple[int, float, np.ndarray] | None = None
    for np_i in ladder if ladder is not None else nprobe_ladder(nlist):
        if np_i >= nlist:
            break
        gots = {name: np.asarray(fn(xq, k, np_i)) for name, fn in fns.items()}
        rec = min(recall_at_k(g, want, k) for g in gots.values())
        points.append((np_i, rec))
        if rec >= recall_target:
            chosen = (np_i, rec, gots[anchor])
            break
    if chosen is None:  # only the full probe reaches (or approaches) the target
        chosen = (nlist, ceiling, full)
        points.append((nlist, ceiling))
    rec_rel = recall_at_k(chosen[2], full, k)
    return {
        "nprobe": int(chosen[0]),
        "recall": float(chosen[1]),
        "recall_rel": float(rec_rel),
        "recall_abs": float(chosen[1]) if exact else None,
        "oracle": "exact" if exact else "full_probe",
        "ceiling": float(ceiling),
        "ceilings": {name: float(c) for name, c in sorted(ceilings.items())},
        # Unreachable in EITHER mode when even the worst regime's full probe
        # misses the target (relative mode can fail too: cross-regime
        # disagreement caps min-recall below 1.0).
        "target_unreachable": bool(ceiling < recall_target),
        "k": int(k),
        "recall_target": float(recall_target),
        "ladder": [(int(a), float(b)) for a, b in points],
        "regimes": sorted(fns),
    }
