"""Streaming flat scan: the counterpart of ``lotus_tpu/ops/pallas_flat.py``.

K2 (``csrc/flat_scan.cu``, a CUDA kernel written for sm_90a) scans every
row of a store once per query and keeps, for each query and each of NL = 128
lanes (lane = row mod 128), the best two scores: a candidate pool of 256 per
query that the caller top-k's (the reference's recall note, ``pallas_flat.py``
:17-19: a true top-k row is lost only when three of them share a lane).

- ``scan_fold``: K2's wrapper (launch counter ``scan_fold.launches``);
  ``scan_fold_reference`` is its plain PyTorch version, which only tensors on
  the CPU take;
- ``flat_search_pallas``: the exhaustive search over a Flat store
  (``pallas_flat.py:181-220``).  Unlike the reference it needs no 256-query
  or 1024-row padding: K2 masks a ragged row tail itself, so any ``n_rows``
  is served;
- ``ivf_residual_scan``: the exhaustive scan of a block-aligned IVF store
  with the exact f32 q.c bias per (block, query) and a row mask for list
  padding (``pallas_flat.py:223-299``).

``QU``, ``BLK`` and ``NL`` keep the reference's contract (``NL`` lanes,
rows padded or masked to ``BLK``) although the CUDA tiles differ.
"""

from __future__ import annotations

import ctypes
from typing import Any

import torch

from lotus_tpu_torch.ops.common import MASK_SCORE, NO_HIT, cdiv, dedup_topk

QU = 256    # queries per tile of the reference kernel
BLK = 1024  # db rows per grid step of the reference kernel (the default bias block)
NL = 128    # candidate lanes (running top-2 each): lane = row mod NL
REF_BLOCK_ROWS = 65536  # rows per plain-version step: bounds its (B, rows) score tile

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.float16: 3}
# How K2 loads the store (flat_scan.cu's Loader): through the producer's
# registers, by TMA, or by TMA as raw int8, f16 or f32 rows converted to bf16
# in shared memory.
_LOADERS = ("register", "tma", "tma+convert")


def kernel_variant(q_dtype: torch.dtype, x_dtype: torch.dtype, d: int) -> str:
    """K2's accept and loader rule (``flat_scan.cu::pick_loader`` and
    ``lotus_flat_scan``): the store loader K2 takes for these operands when
    both bases are 16-byte aligned, or ``ValueError`` for a pair it lacks.

    int8 queries take the int8 dot on an int8 store (TMA at d % 16 == 0).
    bf16 queries take a bf16 store (TMA at d % 8 == 0), or an int8 (d % 16),
    f32 or f16 (d % 8) store loaded raw and converted to bf16 in shared
    memory, as the reference casts the store to the queries' type.  Other
    depths go through the producer's registers.
    """
    i8, bf = torch.int8, torch.bfloat16
    if q_dtype == i8 and x_dtype == i8:
        return _LOADERS[1] if d % 16 == 0 else _LOADERS[0]
    if q_dtype == bf and x_dtype == bf:
        return _LOADERS[1] if d % 8 == 0 else _LOADERS[0]
    if q_dtype == bf and x_dtype == i8:
        return _LOADERS[2] if d % 16 == 0 else _LOADERS[0]
    if q_dtype == bf and x_dtype in (torch.float32, torch.float16):
        return _LOADERS[2] if d % 8 == 0 else _LOADERS[0]
    raise ValueError(f"scan_fold: unsupported dtypes {q_dtype} / {x_dtype}")


def _merge_top2(run, new):
    """Top-2 per lane of two consecutive row ranges, ``run`` before ``new``:
    the later best wins only when strictly greater, the earlier second
    unless the later candidate is strictly greater (ties to the earlier row)."""
    rb, rbi, rs, rsi = run
    nb, nbi, ns, nsi = new
    up = nb > rb
    c1s, c1i = torch.where(up, rb, rs), torch.where(up, rbi, rsi)
    c2s, c2i = torch.where(up, ns, nb), torch.where(up, nsi, nbi)
    keep = c1s >= c2s
    return (torch.where(up, nb, rb), torch.where(up, nbi, rbi),
            torch.where(keep, c1s, c2s), torch.where(keep, c1i, c2i))


def scan_fold_reference(
    xq: torch.Tensor,
    xb: torch.Tensor,
    n_valid: int,
    scales: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
    row_mask: torch.Tensor | None = None,
    *,
    blk: int = BLK,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2 (and of ``_scan_kernel``): the same scores,
    masks and tie order as the kernel.

    Returns ``(best_s, best_i, sec_s, sec_i)``, each (B, NL): per lane the
    top-2 by (score desc, row asc) over rows < ``n_valid``; lanes with fewer
    than two live rows hold (MASK_SCORE, NO_HIT).  The rows go in blocks of
    ``REF_BLOCK_ROWS``; within a block ``max`` over the slices returns the
    first (lowest-row) maximum, which is the sequential fold's tie rule.
    """
    from lotus_tpu_torch.ops.quant import exact_int8_dot

    b = xq.shape[0]
    n = max(0, min(int(n_valid), xb.shape[0]))
    dev = xb.device
    run = (
        torch.full((b, NL), MASK_SCORE, dtype=torch.float32, device=dev),
        torch.full((b, NL), NO_HIT, dtype=torch.int32, device=dev),
        torch.full((b, NL), MASK_SCORE, dtype=torch.float32, device=dev),
        torch.full((b, NL), NO_HIT, dtype=torch.int32, device=dev),
    )
    lane = torch.arange(NL, dtype=torch.int32, device=dev)
    for lo in range(0, n, REF_BLOCK_ROWS):
        hi = min(lo + REF_BLOCK_ROWS, n)
        x = xb[lo:hi]
        if xq.dtype == torch.int8:
            s = exact_int8_dot(xq, x).float()
        elif dev.type == "cuda":  # bf16 operands on the tensor cores, f32 sums
            s = torch.mm(xq, x.to(torch.bfloat16).T, out_dtype=torch.float32)
        else:  # bf16 operands (int8 -> bf16 is exact, f32 rounds), f32 sums
            s = xq.float() @ x.to(torch.bfloat16).float().T
        if scales is not None:
            s.mul_(scales[lo:hi][None, :])
        rows = torch.arange(lo, hi, device=dev)
        if bias is not None:
            s.add_(bias.index_select(0, rows // blk)[:, :b].T)
        if row_mask is not None:
            s.masked_fill_(row_mask[lo:hi][None, :] == 0, MASK_SCORE)
        pad = -(hi - lo) % NL
        if pad:
            s = torch.cat([s, torch.full((b, pad), MASK_SCORE, dtype=s.dtype, device=dev)], 1)
        s = s.reshape(b, -1, NL)
        best, t1 = s.max(dim=1)
        s.scatter_(1, t1[:, None, :], MASK_SCORE)
        sec, t2 = s.max(dim=1)
        ids1 = (lo + t1 * NL + lane).to(torch.int32)
        ids2 = (lo + t2 * NL + lane).to(torch.int32)
        run = _merge_top2(run, (
            best, torch.where(best == MASK_SCORE, NO_HIT, ids1),
            sec, torch.where(sec == MASK_SCORE, NO_HIT, ids2),
        ))
    return run


def scan_fold(
    xq: torch.Tensor,
    xb: torch.Tensor,
    n_valid: int,
    scales: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
    row_mask: torch.Tensor | None = None,
    *,
    blk: int = BLK,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's wrapper.  On CUDA tensors it launches the kernel (or raises);
    only tensors on the CPU take ``scan_fold_reference``.

    ``xq``: (B, d) int8 queries (with an int8 store: the exact int8 dot) or
    bf16 queries; ``xb``: (rows, d) int8, bf16, f16 or f32 store (f16 and
    f32 round to bf16); ``scales``: (rows,) f32 row factors or None; ``bias``:
    (ceil(n / blk), B) f32, added per (row // blk, query), or None;
    ``row_mask``: (rows,) int8 or bool, 0 masks the row, or None.
    Returns ``(best_s, best_i, sec_s, sec_i)``, each (B, NL).
    """
    args = (xq, xb, n_valid, scales, bias, row_mask)
    if not xb.is_cuda:
        return scan_fold_reference(*args, blk=blk)
    from lotus_tpu_torch.ops import _kernels

    if xq.ndim != 2 or xb.ndim != 2 or xq.shape[1] != xb.shape[1]:
        raise ValueError(f"scan_fold: xq {tuple(xq.shape)} and xb {tuple(xb.shape)} need one depth")
    b, d = xq.shape
    kernel_variant(xq.dtype, xb.dtype, d)
    n_scan = max(0, min(int(n_valid), xb.shape[0]))
    if blk <= 0 or blk % NL:
        raise ValueError(f"scan_fold: blk {blk} must be a positive multiple of {NL}")
    for name, t in (("xq", xq), ("xb", xb), ("scales", scales), ("bias", bias), ("row_mask", row_mask)):
        if t is not None and (t.device != xb.device or not t.is_contiguous()):
            raise ValueError(f"scan_fold: {name} must be a contiguous tensor on {xb.device}")
    if scales is not None and (scales.dtype != torch.float32 or scales.shape != (xb.shape[0],)):
        raise ValueError(f"scan_fold: scales must be a ({xb.shape[0]},) f32 tensor")
    if bias is not None and (bias.dtype != torch.float32 or bias.ndim != 2 or bias.shape[1] != b
                             or bias.shape[0] < cdiv(n_scan, blk)):
        raise ValueError(f"scan_fold: bias must be a ({cdiv(n_scan, blk)}, {b}) f32 tensor")
    if row_mask is not None and (row_mask.dtype not in (torch.int8, torch.bool)
                                 or row_mask.shape != (xb.shape[0],)):
        raise ValueError(f"scan_fold: row_mask must be a ({xb.shape[0]},) int8 or bool tensor")

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _kernels.lib()
    codes = (_DTYPE_CODE[xq.dtype], _DTYPE_CODE[xb.dtype])
    sms = torch.cuda.get_device_properties(xb.device).multi_processor_count
    splits, rows_per_split = ctypes.c_int(), ctypes.c_int()
    lib.lotus_flat_scan_plan(b, n_scan, sms, ctypes.byref(splits), ctypes.byref(rows_per_split))
    splits, rows_per_split = splits.value, rows_per_split.value
    out_s = torch.empty((b, 2 * NL), dtype=torch.float32, device=xb.device)
    out_i = torch.empty((b, 2 * NL), dtype=torch.int32, device=xb.device)
    part_s = torch.empty((splits, b, 2 * NL), dtype=torch.float32, device=xb.device)
    part_i = torch.empty((splits, b, 2 * NL), dtype=torch.int32, device=xb.device)
    loader, streamed = ctypes.c_int(), ctypes.c_int()
    code = lib.lotus_flat_scan(
        ptr(xq), ptr(xb), ptr(scales), ptr(bias), ptr(row_mask), ptr(part_s), ptr(part_i),
        ptr(out_s), ptr(out_i), b, d, n_scan, splits, rows_per_split, blk, *codes,
        torch.cuda.current_stream(xb.device).cuda_stream, ctypes.byref(loader), ctypes.byref(streamed),
    )
    _kernels.check(code, "flat_scan launch")
    scan_fold.launches += 1
    scan_fold.last_plan = {"loader": _LOADERS[loader.value], "query": "streamed" if streamed.value else "resident",
                           "splits": splits, "rows_per_split": rows_per_split}
    return out_s[:, :NL], out_i[:, :NL], out_s[:, NL:], out_i[:, NL:]


scan_fold.launches = 0  # K2 launches in this process (read by chip_smoke.py)
# The last launch's store loader, query tile (resident or streamed with the
# stages) and split plan (read by chip_smoke.py and the card tests).
scan_fold.last_plan = None


def _pool_topk(pool, q_scales: torch.Tensor | None, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's merge (``pallas_flat.py:171-177``): the 2 * NL
    candidates times the query scales, top-k, NO_HIT on masked scores."""
    best_s, best_i, sec_s, sec_i = pool
    cand_s = torch.cat([best_s, sec_s], 1)
    cand_i = torch.cat([best_i, sec_i], 1)
    if q_scales is not None:
        cand_s = cand_s * q_scales[:, None]
    top_s, pos = torch.topk(cand_s, min(k, 2 * NL), dim=1)
    top_i = torch.gather(cand_i, 1, pos)
    return top_s, torch.where(top_s <= MASK_SCORE / 2, NO_HIT, top_i)


def flat_search_pallas(
    xb: torch.Tensor,
    xq: torch.Tensor,
    k: int,
    *,
    n_rows: int | None = None,
    xb_scales: torch.Tensor | None = None,
    int8_queries: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming exhaustive search through K2 (ip/cosine; max-is-better
    scores), port of ``pallas_flat.py:181-220``.

    int8 databases score int8 x int8 when ``int8_queries`` (the per-query
    scales are rank-neutral and applied at the merge), otherwise bf16
    queries.  Rows at or past ``n_rows`` are masked.  Returns (B, min(k,
    256)) scores and int32 row ids, NO_HIT where the pool runs dry.
    """
    n = xb.shape[0] if n_rows is None else int(n_rows)
    q_scales = None
    if xb.dtype == torch.int8:
        if xb_scales is None:
            raise ValueError("int8 databases require xb_scales")
        if int8_queries:
            from lotus_tpu_torch.ops.quant import quantize_rows

            xq, q_scales = quantize_rows(xq)
        else:
            xq = xq.to(torch.bfloat16)
    else:
        xq = xq.to(torch.bfloat16)
    pool = scan_fold(xq.contiguous(), xb, n, xb_scales)
    return _pool_topk(pool, q_scales, k)


def residual_scan_inputs(
    state: dict[str, Any], xq: torch.Tensor, *, int8_queries: bool = True,
) -> tuple[tuple, int, torch.Tensor | None]:
    """What ``ivf_residual_scan`` gives K2 for a block-aligned ip/cosine IVF
    store: ``(args, blk, q_scales)``, so that ``scan_fold(*args, blk=blk)``
    scans every storage row and ``q_scales`` (or None) goes to the merge.

    Block-aligned storage keeps every ``block_align`` block inside one list,
    so the exact f32 coarse term q.c of residual stores is one value per
    (block, query): a (n_blocks, B) bias plane.  List padding is masked by
    ``row_ids >= 0``.
    """
    from lotus_tpu_torch.ops.ivf import ensure_pos_list

    meta = state["meta"]
    blk = int(meta.get("block_align", 0))
    if blk not in (512, 1024) or meta.get("metric") == "l2":
        raise ValueError("ivf_residual_scan needs a block-aligned ip/cosine store")
    vecs = state["ivf_vectors"]
    rows = vecs.shape[0] // blk * blk  # a window tail is dead (never in a list)
    scales = state.get("ivf_row_scales")
    residual = meta.get("encoding") == "residual_int8" and vecs.dtype == torch.int8

    xqf = xq.float()
    bias = None
    if residual:
        qc = xqf @ state["centroids"].T  # (b, nlist), exact f32
        block_lists = ensure_pos_list(state)[:rows:blk].long()
        bias = qc[:, block_lists].T.contiguous()  # (n_blocks, b)
    mask = (state["ivf_row_ids"][:rows] >= 0).to(torch.int8)

    q_scales = None
    if vecs.dtype == torch.int8 and int8_queries and not residual:
        from lotus_tpu_torch.ops.quant import quantize_rows

        xq_in, q_scales = quantize_rows(xqf)
    else:
        # Residual scoring adds a bias, so the per-query scale is not
        # rank-neutral: queries stay bf16.
        xq_in = xqf.to(torch.bfloat16)
    args = (xq_in.contiguous(), vecs[:rows], rows, None if scales is None else scales[:rows], bias, mask)
    return args, blk, q_scales


def ivf_residual_scan(
    state: dict[str, Any],
    xq: torch.Tensor,
    k: int,
    *,
    rescore: int | None = 64,
    int8_queries: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exhaustive K2 scan of a block-aligned IVF store (ip/cosine), port of
    ``pallas_flat.py:223-299``.

    Every row is scanned (no coarse-probe loss) with the inputs of
    ``residual_scan_inputs``; the candidates are deduped (spilled rows
    appear twice) and, with ``rescore``, exactly re-ranked.  Returns
    (scores, original row ids).
    """
    from lotus_tpu_torch.ops.ivf import rescore_candidates

    args, blk, q_scales = residual_scan_inputs(state, xq, int8_queries=int8_queries)
    k_cand = max(k, rescore or k)
    s, pos = _pool_topk(scan_fold(*args, blk=blk), q_scales, k_cand)
    row_ids = state["ivf_row_ids"]
    ids = torch.where(pos >= 0, row_ids[torch.clamp(pos, min=0).long()], NO_HIT)
    s, ids = dedup_topk(s, ids, k_cand)
    if rescore is not None:
        return rescore_candidates(state, xq.float(), ids, k)
    return s[:, :k], ids[:, :k]
