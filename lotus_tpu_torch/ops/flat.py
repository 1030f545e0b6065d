"""Exact (Flat) vector search: blocked matmul scoring + running top-k merge.

Port of ``lotus_tpu/ops/flat.py`` (``flat_search`` :229, ``_flat_search_impl``
:101-186, ``flat_rescore`` :188-227).  The reference leaves this to XLA; here
it is ``torch.matmul`` and ``torch.topk``.  The database is scanned in
row-blocks; each block's local top-k merges into a running top-k, so peak
memory is O(B * (k + block_rows)).  A ragged last block is scanned as it
is, so unlike the reference the storage needs no padding to whole blocks.
Subset search is a validity mask.

Metrics follow faiss conventions: ``ip``/``cosine`` similarities are returned
as-is (higher = closer); ``l2`` returns squared euclidean distance.
"""

from __future__ import annotations

from typing import Optional

import torch

from lotus_tpu_torch.ops.common import MASK_SCORE, NO_HIT, as_distance, check_metric

DEFAULT_BLOCK_ROWS = 8192


def _scores_for_block(
    xq: torch.Tensor,
    block: torch.Tensor,
    metric: str,
    block_norms_sq: Optional[torch.Tensor],
    block_scales: Optional[torch.Tensor] = None,
    q_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, d) x (block, d) -> (B, block) max-is-better scores in f32."""
    if block.dtype == torch.int8:
        from lotus_tpu_torch.ops.quant import int8_scores

        if block_scales is None or q_scale is None:
            raise ValueError("int8 blocks need row and query scales")
        sims = int8_scores(xq, q_scale, block, block_scales)
        if metric in ("ip", "cosine"):
            return sims
        if block_norms_sq is None:
            raise ValueError("l2 over int8 storage requires precomputed row norms")
        return 2.0 * sims - block_norms_sq[None, :]
    if block.dtype == torch.bfloat16 or xq.dtype == torch.bfloat16:
        # bf16 operands, f32 accumulation: bf16 products are exact in f32.
        a, b = xq.to(torch.bfloat16).float(), block.to(torch.bfloat16).float()
    else:
        a, b = xq.float(), block.float()
    sims = a @ b.T
    if metric in ("ip", "cosine"):
        return sims
    if block_norms_sq is None:
        bf = block.float()
        block_norms_sq = torch.sum(bf * bf, dim=-1)
    return 2.0 * sims - block_norms_sq[None, :]


def _pad_cols(s: torch.Tensor, i: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    pad = k - s.shape[1]
    if pad <= 0:
        return s, i
    b = s.shape[0]
    s = torch.cat([s, torch.full((b, pad), MASK_SCORE, dtype=s.dtype, device=s.device)], 1)
    i = torch.cat([i, torch.full((b, pad), NO_HIT, dtype=i.dtype, device=i.device)], 1)
    return s, i


def _flat_search_impl(
    xb: torch.Tensor,
    xq: torch.Tensor,
    n_rows: int,
    valid: Optional[torch.Tensor],
    xb_norms_sq: Optional[torch.Tensor],
    k: int,
    metric: str,
    block_rows: int,
    xb_scales: Optional[torch.Tensor] = None,
    q_scale: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    n_pad = xb.shape[0]
    b = xq.shape[0]
    dev = xb.device
    if metric == "l2" and xb_norms_sq is None:
        xf = xb.float()
        xb_norms_sq = torch.sum(xf * xf, dim=-1)
        if xb.dtype == torch.int8:
            xb_norms_sq = xb_norms_sq * (xb_scales * xb_scales)

    best_s = torch.full((b, k), MASK_SCORE, dtype=torch.float32, device=dev)
    best_i = torch.full((b, k), NO_HIT, dtype=torch.int32, device=dev)
    for lo in range(0, n_pad, block_rows):
        hi = min(lo + block_rows, n_pad)
        scores = _scores_for_block(
            xq, xb[lo:hi], metric,
            xb_norms_sq[lo:hi] if xb_norms_sq is not None else None,
            xb_scales[lo:hi] if xb_scales is not None else None, q_scale,
        )
        gids = torch.arange(lo, hi, dtype=torch.int32, device=dev)
        row_ok = gids < n_rows
        if valid is not None:
            row_ok = row_ok & valid[lo:hi]
        scores = torch.where(row_ok[None, :], scores, torch.full_like(scores, MASK_SCORE))
        top_s, pos = torch.topk(scores, min(k, scores.shape[1]), dim=1)
        top_i = torch.where(top_s <= MASK_SCORE / 2, NO_HIT, pos.to(torch.int32) + lo)
        top_s, top_i = _pad_cols(top_s, top_i, k)
        if lo == 0:
            best_s, best_i = top_s, top_i
            continue
        cat_s = torch.cat([best_s, top_s], 1)
        cat_i = torch.cat([best_i, top_i], 1)
        best_s, pos = torch.topk(cat_s, k, dim=1)
        best_i = torch.gather(cat_i, 1, pos)
    return best_s, best_i


def flat_rescore(
    xb: torch.Tensor,
    xq: torch.Tensor,
    cand_i: torch.Tensor,
    k: int,
    *,
    xb_scales: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 re-rank of flat-scan candidates (ip/cosine): rebuild the
    candidate rows at f32 (int8 storage dequantizes by its per-row scale)
    and re-rank with full-precision queries."""
    safe = torch.clamp(cand_i, min=0).long()
    v = xb[safe].float()
    if xb_scales is not None:
        v = v * xb_scales[safe][..., None]
    s = torch.einsum("qd,qmd->qm", xq.float(), v)
    s = torch.where(cand_i == NO_HIT, torch.full_like(s, MASK_SCORE), s)
    top_s, pos = torch.topk(s, min(k, s.shape[1]), dim=1)
    top_i = torch.gather(cand_i, 1, pos)
    return top_s, torch.where(top_s <= MASK_SCORE / 2, NO_HIT, top_i)


def flat_search(
    xb: torch.Tensor,
    xq: torch.Tensor,
    k: int,
    *,
    metric: str = "ip",
    n_rows: int | None = None,
    valid: Optional[torch.Tensor] = None,
    xb_norms_sq: Optional[torch.Tensor] = None,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    approx: bool = False,
    recall_target: float = 0.95,
    xb_scales: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k search of ``xq`` against ``xb``.

    int8 databases (``xb.dtype == int8`` with per-row ``xb_scales``) are
    scored int8 x int8 exactly; queries are quantized per call.

    ``approx`` and ``recall_target`` are accepted for signature parity with
    the reference, whose approximate mode is the TPU's PartialReduce
    (``approx_max_k``).  There is no such unit here: the top-k served is
    always exact.

    Returns (distances, indices): (B, k) f32 distances in metric convention
    and (B, k) int32 row indices, -1 where fewer than k valid rows exist.
    """
    del approx, recall_target
    check_metric(metric)
    squeeze = xq.ndim == 1
    if squeeze:
        xq = xq[None, :]
    if xq.dtype == torch.float64:
        xq = xq.float()
    n_rows = xb.shape[0] if n_rows is None else int(n_rows)

    q_scale = None
    xq_orig = xq
    if xb.dtype == torch.int8:
        from lotus_tpu_torch.ops.quant import quantize_rows

        if xb_scales is None:
            raise ValueError("int8 databases require xb_scales (per-row dequant factors)")
        xq, q_scale = quantize_rows(xq)

    scores, idx = _flat_search_impl(
        xb, xq, n_rows, valid, xb_norms_sq, k, metric, block_rows, xb_scales, q_scale
    )
    dists = as_distance(scores, metric)
    if metric == "l2":
        xo = xq_orig.float()
        dists = dists + torch.sum(xo * xo, dim=-1, keepdim=True)
        dists = torch.where(idx == NO_HIT, torch.finfo(torch.float32).max, dists)
    if squeeze:
        return dists[0], idx[0]
    return dists, idx
