"""The numbers that decide ``correct``: each a plain function of the
program's answers and the reference's.  A missing answer (id -1) reads as
an infinite gap."""

from __future__ import annotations

import numpy as np
import torch


def recall(ret_ids: np.ndarray, exact_ids: np.ndarray) -> float:
    """Share of the exact top-k ids among the returned ones, over all rows."""
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ret_ids, exact_ids))
    return hits / exact_ids.size


def score_err(ret_ids: np.ndarray, ret_scores: np.ndarray, exact_ret_scores: np.ndarray) -> float:
    """Widest gap between a returned score and the exact f32 score of the
    returned id."""
    if (ret_ids < 0).any():
        return float("inf")
    return float(np.max(np.abs(ret_scores.astype(np.float64) - exact_ret_scores.astype(np.float64))))


def row_err(store_rows: torch.Tensor, exact_rows: torch.Tensor) -> float:
    """Widest L2 distance between a stored row, as the store reconstructs
    it, and the corpus row it stands for."""
    return float(torch.linalg.vector_norm(store_rows.float() - exact_rows.float(), dim=1).max())


def emb_gap(emb: np.ndarray, ref_emb: np.ndarray) -> float:
    """Widest L2 distance between an embedding and the reference's."""
    return float(np.linalg.norm(emb.astype(np.float64) - ref_emb.astype(np.float64), axis=1).max())


def join_gap(ret_ids: np.ndarray, ret_scores: np.ndarray, left: np.ndarray, right: np.ndarray,
             device: torch.device | str = "cpu") -> float:
    """Widest gap, over every returned (row, id), by which the reference's
    score of the pair lies below the reference's k-th best for the row, or
    by which the returned score departs from the reference's score of the
    pair (``left`` the reference's embeddings of the rows, ``right`` of
    every right-side row), in f64 on ``device``."""
    if (ret_ids < 0).any():
        return float("inf")
    k = ret_ids.shape[1]
    lt = torch.from_numpy(left).to(device, torch.float64)
    rt = torch.from_numpy(right).to(device, torch.float64)
    kth = torch.topk(lt @ rt.T, k, dim=1).values[:, -1:].cpu().numpy()
    pair = np.einsum("qd,qkd->qk", left.astype(np.float64), right[ret_ids].astype(np.float64))
    return float(max(np.max(kth - pair), np.max(np.abs(ret_scores.astype(np.float64) - pair))))


def check(name: str, value: float, limit: float, kind: str) -> dict:
    """One compared number: ``kind`` "max" passes at or below ``limit``,
    "min" at or above it."""
    ok = value <= limit if kind == "max" else value >= limit
    return {"name": name, "value": value, "limit": limit, "kind": kind, "ok": bool(ok and np.isfinite(value))}
