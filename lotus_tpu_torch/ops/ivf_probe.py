"""Grouped IVF probe: the counterpart of ``lotus_tpu/ops/pallas_ivf.py``.

The reference runs its one Pallas kernel, ``_probe_kernel``, over work-unit
tables that XLA builds.  Here K5 (``probe_layout``, ``csrc/probe_layout.cu``)
builds the tables and K1 (``csrc/ivf_probe.cu``) does the probe, both CUDA
kernels written for sm_90a:

1. coarse ranking: exact ``flat_search`` over the centroids (plus the exact
   q.c bias per probe slot on residual stores);
2. pair grouping WITHOUT a sort: a (query, list) pair's rank within its list
   is the number of earlier queries that probed the list (K5: popcounts
   over a one-bit-a-pair table; the plain version: an exclusive cumsum over
   the (b, nlist) 0/1 probe histogram, an argsort above b * nlist > 2**26);
3. the chunk table (list id of every 128-pair chunk) and the padded query
   layout (K5, in the same launches);
4. K1 (``probe_fold``): per (list, chunk) a top-2 per 64 strided lanes
   across the whole list, 128 candidates per pair (a top-1, 64 candidates,
   under ``FOLD = "top1"``);
5. K3 (``pool_select``, ``csrc/pool_select.cu``): per query, reassembly per
   pair, packed-id decode, residual bias and the pool top-k in one launch;
   then dedup on spilled stores only, and the per-query int8 scale;
6. optional exact f32 rescoring (``ops/ivf.py::rescore_candidates``).

Each call is the span ``ivf.search`` (``lotus_tpu_torch.profiling``); each
query slice opens ``ivf.coarse`` (1), ``ivf.layout`` (2-3), ``ivf.k1`` (4),
``ivf.pool`` (5) and ``ivf.rescore`` (6) under it.

A slice needs no host sync: K1's grid is the static bound
``P // QU + nlist + 1`` and blocks past the live chunk count write
MASK_SCORE.  The reference's experiment knobs that are off by default
(``_DEBUG_STAGE``, ``POOL_PREREDUCE``, ``CUMSUM_MATMUL``, ``APPROX_TOPK``,
``COARSE_APPROX``) are not carried; its fold mode ``FOLD`` is.

Requires an index built with ``build_ivf(..., block_align=...)``.
"""

from __future__ import annotations

import ctypes
from typing import Any

import torch

from lotus_tpu_torch.ops.common import MASK_SCORE, NO_HIT, as_distance, cdiv, dedup_topk
from lotus_tpu_torch.ops.flat import flat_search
from lotus_tpu_torch.ops.ivf import ensure_norms_sq, rescore_candidates
from lotus_tpu_torch.profiling import annotate

QU = 128  # query slots per chunk
BL = 1024  # default build alignment (db rows per kernel block)
BUCKET = 8  # buckets per 512 storage rows -> NBK = 64 lanes, 128 candidates per pair
NBK = 512 // BUCKET
# Fold mode, as the reference's (pallas_ivf.py:63): "top2" keeps two
# survivors per lane, "top1" one (64 candidates per pair; pair collisions
# return).  Read at each call of ``_grouped_probe``.
FOLD = "top2"
NCAND = 2 * NBK  # candidates per pair under the default top-2 fold
LOCAL_BITS = 13  # packed ids cover probe windows up to 8192 rows
_LOCAL_MASK = (1 << LOCAL_BITS) - 1
# Above this many histogram cells the plain pair grouping takes one stable sort.
HIST_MAX_CELLS = 1 << 26

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.float16: 3}
# How K1 ran (ivf_probe.cu's Route): on the CUDA cores (f32, or rows TMA
# cannot describe), or on the tensor cores with the store loaded by TMA, or
# by TMA as raw int8 rows converted to bf16 in shared memory.
_ROUTES = ("cuda-cores", "wgmma+tma", "wgmma+tma+convert")


def kernel_variant(q_dtype: torch.dtype, x_dtype: torch.dtype, d: int, *, int8_dot: bool, l2: bool) -> str:
    """K1's accept and route rule (``ivf_probe.cu::pick_route`` and
    ``lotus_ivf_probe``): the route K1 takes for these operands when every
    base is 16-byte aligned, or ``ValueError`` for a pair it lacks.

    The int8 dot (int8 queries and rows, not l2) takes any d: the tensor
    cores at d % 16 == 0, else the CUDA cores with a ragged last word.  bf16
    queries run on bf16 rows (TMA at d % 8 == 0) or int8 rows (converted, at
    d % 16 == 0); f32 queries on f32 or f16 rows run on the CUDA cores in
    full f32, as the reference computes them at ``Precision.HIGHEST``.
    """
    i8, bf = torch.int8, torch.bfloat16
    if int8_dot:
        if q_dtype != i8 or x_dtype != i8 or l2:
            raise ValueError("probe_fold: int8_dot needs int8 queries and storage and no l2")
        return _ROUTES[1] if d % 16 == 0 else _ROUTES[0]
    if q_dtype == bf and x_dtype == bf:
        return _ROUTES[1] if d % 8 == 0 else _ROUTES[0]
    if q_dtype == bf and x_dtype == i8:
        return _ROUTES[2] if d % 16 == 0 else _ROUTES[0]
    if q_dtype == torch.float32 and x_dtype in (torch.float32, torch.float16):
        return _ROUTES[0]
    raise ValueError(f"probe_fold: unsupported dtypes {q_dtype} / {x_dtype}")


def ncand(top1: bool) -> int:
    """Candidates per pair of K1's output: 64 under the top-1 fold, else 128."""
    return NBK if top1 else 2 * NBK


def probe_fold_reference(
    xq_units: torch.Tensor,
    xb: torch.Tensor,
    scales: torch.Tensor | None,
    norms: torch.Tensor | None,
    chunk_list: torch.Tensor,
    list_start: torch.Tensor,
    list_size: torch.Tensor,
    *,
    bl: int,
    int8_dot: bool,
    l2: bool,
    packed: bool,
    top1: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain PyTorch version of K1: the same scores, masking, packed-id bits
    and fold order as the kernel (and as ``_probe_kernel``).

    Returns ``(out_s, out_i)`` of shape ``(len(chunk_list), QU, ncand(top1))``;
    ``out_i`` is None when ``packed``.  Rows of chunks whose table entry is
    -1 hold MASK_SCORE (ids 0).
    """
    from lotus_tpu_torch.ops.quant import exact_int8_dot

    grid = chunk_list.shape[0]
    nc = ncand(top1)
    dev = xb.device
    out_s = torch.full((grid, QU, nc), MASK_SCORE, dtype=torch.float32, device=dev)
    out_i = None if packed else torch.zeros((grid, QU, nc), dtype=torch.int32, device=dev)
    starts, sizes = list_start.cpu().tolist(), list_size.cpu().tolist()
    for c, lid in enumerate(chunk_list.cpu().tolist()):
        if lid < 0:
            continue
        start, size = starts[lid], sizes[lid]
        nrows = cdiv(size, bl) * bl
        if nrows == 0:
            continue
        q = xq_units[c * QU : (c + 1) * QU]
        x = xb[start : start + nrows]
        if int8_dot:
            s = exact_int8_dot(q, x).float()
        elif q.dtype == torch.bfloat16:  # bf16 operands (int8 -> bf16 is exact), f32 sums
            s = q.float() @ x.to(torch.bfloat16).float().T
        else:
            s = q.float() @ x.float().T
        if scales is not None:
            s = s * scales[start : start + nrows][None, :]
        if l2:
            s = 2.0 * s - norms[start : start + nrows][None, :]
        col = torch.arange(nrows, device=dev)
        ok = (col < size)[None, :]
        nsl = nrows // NBK
        if packed:
            bits = s.view(torch.int32)
            pk = ((bits & ~_LOCAL_MASK) | col.to(torch.int32)[None, :]).view(torch.float32)
            pk = torch.where(ok, pk, torch.full_like(pk, MASK_SCORE))
            # Packed values are distinct except masked lanes (all MASK_SCORE),
            # so an order-free top-k equals the kernel's fmaxf/fminf fold.
            # (QU, 1 or 2, NBK): the best of every lane, then the second.
            out_s[c] = torch.topk(pk.reshape(QU, nsl, NBK), nc // NBK, dim=1).values.reshape(QU, nc)
            continue
        s = torch.where(ok, s, torch.full_like(s, MASK_SCORE)).reshape(QU, nsl, NBK)
        best_s = torch.full((QU, NBK), MASK_SCORE, dtype=torch.float32, device=dev)
        sec_s = best_s.clone()
        best_i = torch.zeros((QU, NBK), dtype=torch.int32, device=dev)
        sec_i = best_i.clone()
        lane = torch.arange(NBK, dtype=torch.int32, device=dev)
        for t in range(nsl):  # slice order: ties go to the earlier row (strict '>')
            sl, idx = s[:, t], (start + t * NBK + lane)[None, :].expand(QU, NBK)
            upd, upd2 = sl > best_s, sl > sec_s
            sec_s, sec_i = (
                torch.where(upd, best_s, torch.where(upd2, sl, sec_s)),
                torch.where(upd, best_i, torch.where(upd2, idx, sec_i)),
            )
            best_s, best_i = torch.where(upd, sl, best_s), torch.where(upd, idx, best_i)
        # The top-1 fold's best is the top-2 fold's: the same strict '>'.
        out_s[c] = best_s if top1 else torch.cat([best_s, sec_s], 1)
        out_i[c] = best_i if top1 else torch.cat([best_i, sec_i], 1)
    return out_s, out_i


def probe_fold(
    xq_units: torch.Tensor,
    xb: torch.Tensor,
    scales: torch.Tensor | None,
    norms: torch.Tensor | None,
    chunk_list: torch.Tensor,
    list_start: torch.Tensor,
    list_size: torch.Tensor,
    *,
    bl: int,
    int8_dot: bool,
    l2: bool,
    packed: bool,
    top1: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """K1's wrapper.  On CUDA tensors it launches the kernel (or raises);
    only tensors on the CPU take ``probe_fold_reference``.

    ``xq_units``: (chunks * QU, d) queries in chunk layout; ``xb``: (rows, d)
    block-aligned storage; ``scales`` / ``norms``: (rows,) f32 or None;
    ``chunk_list``: (grid,) int32 list id per chunk, -1 for dead chunks;
    ``list_start`` / ``list_size``: (nlist,) int32; ``top1``: the top-1 fold.
    """
    args = (xq_units, xb, scales, norms, chunk_list, list_start, list_size)
    if not xb.is_cuda:
        return probe_fold_reference(*args, bl=bl, int8_dot=int8_dot, l2=l2, packed=packed, top1=top1)
    from lotus_tpu_torch.ops import _kernels

    d = xb.shape[1]
    grid = chunk_list.shape[0]
    int32_args = {"chunk_list": chunk_list, "list_start": list_start, "list_size": list_size}
    for name, t in (("xq_units", xq_units), ("xb", xb), *int32_args.items()):
        if not t.is_cuda or t.device != xb.device or not t.is_contiguous():
            raise ValueError(f"probe_fold: {name} must be a contiguous tensor on {xb.device}")
    for name, t in int32_args.items():
        if t.dtype != torch.int32 or t.ndim != 1:
            raise ValueError(f"probe_fold: {name} must be a 1-D int32 tensor")
    if xq_units.ndim != 2 or xq_units.shape[1] != d or xq_units.shape[0] < (grid - 1) * QU:
        raise ValueError(f"probe_fold: xq_units {tuple(xq_units.shape)} does not cover {grid - 1} chunks of d={d}")
    if xb.shape[0] % bl != 0 or bl % NBK != 0:
        raise ValueError(f"probe_fold: storage rows {xb.shape[0]} must be whole blocks of bl={bl}")
    kernel_variant(xq_units.dtype, xb.dtype, d, int8_dot=int8_dot, l2=l2)
    if int8_dot and (xq_units.data_ptr() % 4 or xb.data_ptr() % 4):
        raise ValueError("probe_fold: int8_dot reads 32-bit words; xq_units and xb must be 4-byte aligned")
    for name, t, need in (("scales", scales, xb.dtype == torch.int8), ("norms", norms, l2)):
        if need and (t is None or t.dtype != torch.float32 or t.shape != (xb.shape[0],)
                     or not t.is_contiguous() or t.device != xb.device):
            raise ValueError(f"probe_fold: {name} must be a contiguous ({xb.shape[0]},) f32 tensor on {xb.device}")
    nc = ncand(top1)
    out_s = torch.empty((grid, QU, nc), dtype=torch.float32, device=xb.device)
    out_i = None if packed else torch.empty((grid, QU, nc), dtype=torch.int32, device=xb.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    route, streamed = ctypes.c_int(), ctypes.c_int()
    code = _kernels.lib().lotus_ivf_probe(
        ptr(xq_units), ptr(xb), ptr(scales), ptr(norms), ptr(chunk_list), ptr(list_start),
        ptr(list_size), ptr(out_s), ptr(out_i), grid, d, bl, xq_units.shape[0], xb.shape[0],
        _DTYPE_CODE[xq_units.dtype], _DTYPE_CODE[xb.dtype], int(int8_dot), int(l2), int(packed), int(top1),
        torch.cuda.current_stream(xb.device).cuda_stream, ctypes.byref(route), ctypes.byref(streamed),
    )
    _kernels.check(code, "ivf_probe launch")
    probe_fold.launches += 1
    probe_fold.last_plan = {"route": _ROUTES[route.value],
                            "query": "streamed" if streamed.value else "resident"}
    return out_s, out_i


probe_fold.launches = 0  # K1 launches in this process (read by chip_smoke.py)
# The last launch's route (CUDA cores, or tensor cores with TMA or TMA and
# conversion) and query tile (resident or streamed with the stages), read by
# chip_smoke.py and the card tests.
probe_fold.last_plan = None


def probe_layout_reference(
    probe_lists: torch.Tensor, xq_store: torch.Tensor, list_size: torch.Tensor, bl: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5: K1's inputs for a batch by pair
    grouping, chunk table and query layout.

    Returns ``(xq_units, chunk_list, padpos, blocks)``: the queries in chunk
    layout ((grid - 1) * QU, d), zeros in the slots no pair fills, the list
    id of every chunk (grid,) int32 with -1 for dead chunks, each pair's row
    in the kernel output (P,) int64, and the block count of every probed
    list (nlist,).  The grid is the static bound ``P // QU + nlist + 1``.
    On a CUDA tensor the histogram's scatter copies a host scalar, which
    waits for the card.
    """
    b, nprobe = probe_lists.shape
    d = xq_store.shape[1]
    dev = xq_store.device
    nlist = list_size.shape[0]
    p = b * nprobe

    # ---- pair grouping without a sort ------------------------------------
    # probe_lists rows are distinct per query, so a pair's rank within its
    # list is "how many earlier queries probed that list".
    l_flat = probe_lists.reshape(-1).long()
    q_ids = torch.arange(b, dtype=torch.int64, device=dev).repeat_interleave(nprobe)
    if b * nlist <= HIST_MAX_CELLS:
        hist = torch.zeros((b, nlist), dtype=torch.int32, device=dev)
        hist[q_ids, l_flat] = 1
        cum = torch.cumsum(hist, dim=0, dtype=torch.int32)
        counts = cum[-1]
        rank = (cum - hist)[q_ids, l_flat]
    else:
        order = torch.argsort(l_flat, stable=True)
        sl = l_flat[order]
        counts = torch.bincount(l_flat, minlength=nlist).to(torch.int32)
        pair_start = torch.cumsum(counts, 0, dtype=torch.int32) - counts
        rank_sorted = torch.arange(p, dtype=torch.int32, device=dev) - pair_start[sl]
        rank = torch.empty((p,), dtype=torch.int32, device=dev)
        rank[order] = rank_sorted
    rank = rank.long()

    chunks = (counts + (QU - 1)) // QU  # query chunks per list
    chunk_cum = torch.cumsum(chunks, 0, dtype=torch.int32)  # inclusive
    chunk_base = chunk_cum - chunks
    n_chunks_max = p // QU + nlist  # static bound on the live chunk count
    blocks = torch.where(counts > 0, (list_size + (bl - 1)) // bl, torch.zeros_like(list_size))

    # ---- chunk table + padded query layout ---------------------------------
    # Chunk c of list l sits at global chunk id chunk_base[l] + c; its QU
    # slots hold the list's pairs in rank order, the zero query elsewhere.
    # The table has one extra dead entry (the reference's parking row).
    c_ids = torch.arange(n_chunks_max + 1, dtype=torch.int32, device=dev)
    lid = torch.searchsorted(chunk_cum, c_ids, right=True).to(torch.int32)
    chunk_list = torch.where(c_ids < chunk_cum[-1], lid, torch.full_like(lid, -1))
    padpos = (chunk_base.long()[l_flat] + rank // QU) * QU + rank % QU  # (P,)
    sq_full = torch.full((n_chunks_max * QU,), b, dtype=torch.int64, device=dev)
    sq_full[padpos] = q_ids
    xq_pad = torch.cat([xq_store, torch.zeros((1, d), dtype=xq_store.dtype, device=dev)])
    xq_units = xq_pad[sq_full]
    return xq_units, chunk_list, padpos, blocks


def probe_layout(
    probe_lists: torch.Tensor, xq_store: torch.Tensor, list_size: torch.Tensor, bl: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5's wrapper (``csrc/probe_layout.cu``): ``probe_layout_reference``'s
    outputs, equal bit for bit, except that rows of dead chunks
    (``chunk_list == -1``) are left unwritten (K1 never reads them).  On
    CUDA tensors it launches the kernel (or raises), with no host sync;
    tensors on the CPU take the plain version.

    ``probe_lists``: (b, nprobe) int32, distinct lists per row;
    ``xq_store``: (b, d) queries as K1 takes them (int8, bf16, f16 or f32);
    ``list_size``: (nlist,) int32; ``bl``: the store's block rows.
    """
    if probe_lists.ndim != 2 or list_size.ndim != 1:
        raise ValueError("probe_layout: probe_lists must be (b, nprobe) and list_size (nlist,)")
    b, nprobe = probe_lists.shape
    nlist = list_size.shape[0]
    if not xq_store.is_cuda:
        return probe_layout_reference(probe_lists, xq_store, list_size, bl)
    from lotus_tpu_torch.ops import _kernels

    dev = xq_store.device
    checks = (("probe_lists", probe_lists, torch.int32), ("list_size", list_size, torch.int32))
    for name, t, dtype in checks:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"probe_layout: {name} must be a contiguous {dtype} tensor on {dev}")
    if xq_store.dtype not in _DTYPE_CODE or xq_store.ndim != 2 or xq_store.shape[0] != b:
        raise ValueError(f"probe_layout: xq_store must be ({b}, d) in one of {tuple(_DTYPE_CODE)}")
    if not xq_store.is_contiguous():
        raise ValueError("probe_layout: xq_store must be contiguous")
    if bl < 1:
        raise ValueError(f"probe_layout: bl must be positive, got {bl}")
    d = xq_store.shape[1]
    n_chunks_max = b * nprobe // QU + nlist
    xq_units = torch.empty((n_chunks_max * QU, d), dtype=xq_store.dtype, device=dev)
    chunk_list = torch.empty((n_chunks_max + 1,), dtype=torch.int32, device=dev)
    padpos = torch.empty((b * nprobe,), dtype=torch.int64, device=dev)
    blocks = torch.empty((nlist,), dtype=torch.int32, device=dev)
    lib = _kernels.lib()
    work_bytes = lib.lotus_probe_layout_workspace(b, nlist)
    work = torch.empty((work_bytes,), dtype=torch.uint8, device=dev)
    code = lib.lotus_probe_layout(
        probe_lists.data_ptr(), xq_store.data_ptr(), list_size.data_ptr(), xq_units.data_ptr(),
        chunk_list.data_ptr(), padpos.data_ptr(), blocks.data_ptr(), work.data_ptr(), work_bytes, b, nprobe,
        nlist, d * xq_store.element_size(), bl, torch.cuda.current_stream(dev).cuda_stream,
    )
    _kernels.check(code, "probe_layout launch")
    probe_layout.launches += 1
    return xq_units, chunk_list, padpos, blocks


probe_layout.launches = 0  # K5 launches in this process (one an ``ivf.layout`` span on the card)


def pool_candidates(
    cand_pk: torch.Tensor,
    cand_idx: torch.Tensor | None,
    padpos: torch.Tensor,
    probe_lists: torch.Tensor,
    list_start: torch.Tensor,
    list_size: torch.Tensor,
    probe_bias: torch.Tensor | None,
    q_scales: torch.Tensor | None,
    *,
    packed: bool,
    n_rows: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Every query's whole candidate pool as K3 scores it: ``(cand_s,
    cand_i)``, each (b, nprobe * kc), in pair order; ``cand_i`` holds
    storage rows (int32)."""
    b, nprobe = probe_lists.shape
    kc = cand_pk.shape[-1]
    dev = cand_pk.device
    l_flat = probe_lists.reshape(-1).long()
    # ---- reassemble per pair -------------------------------------------
    # Pair p's candidates are row padpos[p] of the kernel output; a pair
    # whose list is empty reads a MASK_SCORE row, and 'empty' masks it too
    # (a probed list has blocks exactly where its size is above 0).
    empty = (list_size[l_flat] > 0)[:, None]
    mask = torch.tensor(MASK_SCORE, dtype=torch.float32, device=dev)
    flat_s = cand_pk.reshape(-1, kc)
    pool = torch.where(empty, flat_s[padpos], mask).reshape(b, nprobe, kc)
    if packed:
        bits = pool.view(torch.int32)
        starts = list_start[probe_lists.long()]  # (b, nprobe)
        cand_i = torch.clamp(starts[:, :, None] + (bits & _LOCAL_MASK), max=n_rows - 1)
        cand_s = (bits & ~_LOCAL_MASK).view(torch.float32)
    else:
        cand_s = pool
        cand_i = cand_idx.reshape(-1, kc)[padpos].reshape(b, nprobe, kc)
    if probe_bias is not None:
        # Residual encoding: every candidate of probe slot s owes the exact
        # coarse term q.c in probe_bias[:, s]; that breaks the rank-neutral
        # query scale, so int8 queries are dequantized here.
        masked = cand_s <= MASK_SCORE / 2
        if q_scales is not None:
            cand_s = cand_s * q_scales[:, None, None]
        cand_s = torch.where(masked, mask, cand_s + probe_bias[:, :, None])
    return cand_s.reshape(b, nprobe * kc), cand_i.reshape(b, nprobe * kc)


def pool_select_reference(
    cand_pk: torch.Tensor,
    cand_idx: torch.Tensor | None,
    padpos: torch.Tensor,
    probe_lists: torch.Tensor,
    list_start: torch.Tensor,
    list_size: torch.Tensor,
    probe_bias: torch.Tensor | None,
    q_scales: torch.Tensor | None,
    *,
    k_out: int,
    packed: bool,
    n_rows: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3: the pool (``pool_candidates``), then its
    top ``k_out`` by ``torch.topk`` with their storage rows."""
    cand_s, cand_i = pool_candidates(cand_pk, cand_idx, padpos, probe_lists, list_start, list_size,
                                     probe_bias, q_scales, packed=packed, n_rows=n_rows)
    top_s, pos = torch.topk(cand_s, k_out, dim=1)
    return top_s, torch.gather(cand_i, 1, pos)


def pool_select(
    cand_pk: torch.Tensor,
    cand_idx: torch.Tensor | None,
    padpos: torch.Tensor,
    probe_lists: torch.Tensor,
    list_start: torch.Tensor,
    list_size: torch.Tensor,
    probe_bias: torch.Tensor | None,
    q_scales: torch.Tensor | None,
    *,
    k_out: int,
    packed: bool,
    n_rows: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's wrapper (``csrc/pool_select.cu``): each query's ``k_out`` best
    pool candidates, descending, and their storage rows (int32).  On CUDA
    tensors it launches the kernel (or raises); only tensors on the CPU take
    ``pool_select_reference``.

    ``cand_pk``: K1's output (grid, QU, kc) f32, kc 64 or 128; ``cand_idx``:
    its storage rows (int32, same shape), read only when not ``packed``;
    ``padpos``: (b * nprobe,) int64 row of each pair; ``probe_lists``: (b,
    nprobe) int32; ``list_start`` / ``list_size``: (nlist,) int32, the sizes
    as K1 got them; ``probe_bias``: (b, nprobe) f32 or None; ``q_scales``:
    (b,) f32 or None, multiplied in before the bias (only with a bias);
    ``n_rows``: the storage rows, the bound of a packed row.
    """
    args = (cand_pk, cand_idx, padpos, probe_lists, list_start, list_size, probe_bias, q_scales)
    if not cand_pk.is_cuda:
        return pool_select_reference(*args, k_out=k_out, packed=packed, n_rows=n_rows)
    from lotus_tpu_torch.ops import _kernels

    dev = cand_pk.device
    b, nprobe = probe_lists.shape
    kc = cand_pk.shape[-1]
    if kc not in (NBK, 2 * NBK) or cand_pk.dtype != torch.float32 or not cand_pk.is_contiguous():
        raise ValueError(f"pool_select: cand_pk must be a contiguous f32 tensor of {NBK} or {2 * NBK} columns")
    if cand_pk.data_ptr() % 16:
        raise ValueError("pool_select: cand_pk must be 16-byte aligned")
    if not 0 <= k_out <= nprobe * kc:
        raise ValueError(f"pool_select: k_out {k_out} outside [0, {nprobe * kc}]")
    probe_lists = probe_lists.contiguous()
    probe_bias = None if probe_bias is None else probe_bias.contiguous()
    q_scales = None if probe_bias is None or q_scales is None else q_scales.contiguous()
    if not packed and (cand_idx is None or cand_idx.shape != cand_pk.shape):
        raise ValueError("pool_select: unpacked candidates need cand_idx of cand_pk's shape")
    checks = (
        ("cand_idx", None if packed else cand_idx, torch.int32, cand_pk.shape),
        ("padpos", padpos, torch.int64, (b * nprobe,)),
        ("probe_lists", probe_lists, torch.int32, (b, nprobe)),
        ("list_start", list_start, torch.int32, list_size.shape),
        ("list_size", list_size, torch.int32, (list_size.shape[0],)),
        ("probe_bias", probe_bias, torch.float32, (b, nprobe)),
        ("q_scales", q_scales, torch.float32, (b,)),
    )
    for name, t, dtype, shape in checks:
        if t is not None and (t.device != dev or t.dtype != dtype or t.shape != shape or not t.is_contiguous()):
            raise ValueError(f"pool_select: {name} must be a contiguous {tuple(shape)} {dtype} tensor on {dev}")
    out_s = torch.empty((b, k_out), dtype=torch.float32, device=dev)
    out_rows = torch.empty((b, k_out), dtype=torch.int32, device=dev)
    if b == 0 or k_out == 0:
        return out_s, out_rows
    lib = _kernels.lib()
    # Device memory for the blocks' tables where they outgrow shared memory
    # (nprobe past about 8,000 or k_out past 16,384); none at served shapes.
    work_bytes = lib.lotus_pool_select_workspace(b, nprobe, k_out)
    work = torch.empty((work_bytes,), dtype=torch.uint8, device=dev) if work_bytes else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    code = lib.lotus_pool_select(
        ptr(cand_pk), ptr(None if packed else cand_idx), ptr(padpos), ptr(probe_lists), ptr(list_start),
        ptr(list_size), ptr(probe_bias), ptr(q_scales), ptr(out_s), ptr(out_rows), ptr(work), work_bytes, b,
        nprobe, kc, k_out, int(packed), n_rows, torch.cuda.current_stream(dev).cuda_stream,
    )
    _kernels.check(code, "pool_select launch")
    pool_select.launches += 1
    return out_s, out_rows


pool_select.launches = 0  # K3 launches in this process (one an ``ivf.pool`` span on the card)


def finish_pool(
    top_s: torch.Tensor,
    top_rows: torch.Tensor,
    row_ids: torch.Tensor,
    k: int,
    *,
    spilled: bool,
    q_scales: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """From the pool's sorted head (``pool_select``) to the probe's answer:
    ids (NO_HIT for masked scores), the dedup of spilled stores or the
    padding of a pool smaller than k, and the rank-neutral query scale
    ``q_scales`` applied last.  Returns ``(scores, ids, storage rows)``."""
    b, k_out = top_s.shape
    dev = top_s.device
    top_i = row_ids[top_rows.long()]
    top_i = torch.where(top_s <= MASK_SCORE / 2, torch.full_like(top_i, NO_HIT), top_i)
    if spilled:
        # Storage rows ride along for the shard-local exact rescore.
        top_s, top_i, top_rows = dedup_topk(top_s, top_i, k, aux=top_rows)
    elif k_out < k:  # pool smaller than k: pad, keeping the sorted head
        pad = k - k_out
        top_s = torch.cat([top_s, torch.full((b, pad), MASK_SCORE, dtype=top_s.dtype, device=dev)], 1)
        top_i = torch.cat([top_i, torch.full((b, pad), NO_HIT, dtype=top_i.dtype, device=dev)], 1)
        top_rows = torch.cat([top_rows, torch.zeros((b, pad), dtype=top_rows.dtype, device=dev)], 1)
    if q_scales is not None:
        # Per-query dequantization constant; rank-neutral, so applied last.
        top_s = torch.where(top_i == NO_HIT, top_s, top_s * q_scales[:, None])
    return top_s, top_i, top_rows


def _grouped_probe(
    centroids: torch.Tensor,
    xb_sorted: torch.Tensor,
    row_ids: torch.Tensor,
    list_start: torch.Tensor,
    list_size: torch.Tensor,
    xq: torch.Tensor,
    row_scales: torch.Tensor | None,
    norms_sq: torch.Tensor | None,
    k: int,
    nprobe: int,
    max_blocks: int,
    metric: str,
    int8_queries: bool,
    owned: torch.Tensor | None = None,
    probe_lists: torch.Tensor | None = None,
    probe_bias: torch.Tensor | None = None,
    return_rows: bool = False,
    packed_ok: bool = False,
    bl: int = 512,
    spilled: bool = True,
    fold=probe_fold,
):
    """Port of ``_grouped_probe_pallas`` (``pallas_ivf.py:313-645``).

    ``owned`` (nlist,) bool: the lists a shard owns; the sizes of the others
    are zeroed before ``probe_layout``, so their pairs get no blocks and read
    masked rows (the sharded caller, ``parallel/ivf.py``).  ``return_rows``
    adds the storage rows of the top-k as a third output, for the shard-local
    exact rescore.  ``fold`` runs K1; a check on the card passes
    ``probe_fold_reference`` to run the same path through the plain version.
    """
    is_int8 = xb_sorted.dtype == torch.int8
    is_l2 = metric == "l2"
    # int8 x int8 needs int8 storage and queries and a metric whose query
    # scale is rank-neutral (not l2: the scale would touch only the dot term).
    int8_dot = is_int8 and int8_queries and not is_l2

    if probe_lists is None:
        with annotate("ivf.coarse"):
            _, probe_lists = flat_search(centroids, xq, nprobe, metric=metric)
    with annotate("ivf.layout", route="kernel" if xq.is_cuda else "plain"):
        probe_lists = probe_lists.to(torch.int32).contiguous()
        if owned is not None:
            list_size = torch.where(owned, list_size, torch.zeros_like(list_size))

        q_scales = None
        if int8_dot:
            from lotus_tpu_torch.ops.quant import quantize_rows

            xq_store, q_scales = quantize_rows(xq)
        elif is_int8 or xb_sorted.dtype == torch.bfloat16:
            xq_store = xq.to(torch.bfloat16)
        else:
            xq_store = xq

        xq_units, chunk_list, padpos, _ = probe_layout(probe_lists, xq_store.contiguous(), list_size, bl)

    # Packing truncates 13 mantissa bits, so it is only used when the caller
    # exactly re-ranks the candidates; windows beyond the packed-id range
    # take the unpacked fold.
    packed = packed_ok and max_blocks * bl <= (1 << LOCAL_BITS)
    top1 = FOLD == "top1"
    with annotate("ivf.k1"):
        cand_pk, cand_idx = fold(
            xq_units, xb_sorted, row_scales if is_int8 else None, norms_sq if is_l2 else None,
            chunk_list, list_start, list_size, bl=bl, int8_dot=int8_dot, l2=is_l2, packed=packed, top1=top1,
        )
    with annotate("ivf.pool", route="kernel" if cand_pk.is_cuda else "plain"):
        # Spilled rows can reach the pool through two lists: 2k head-room and a
        # dedup.  Unspilled pools hold each id once, so the top-k is final.
        k_out = min(2 * k if spilled else k, nprobe * ncand(top1))
        top_s, top_rows = pool_select(
            cand_pk, cand_idx, padpos, probe_lists, list_start, list_size, probe_bias,
            q_scales if probe_bias is not None else None, k_out=k_out, packed=packed,
            n_rows=xb_sorted.shape[0],
        )
        top_s, top_i, top_rows = finish_pool(top_s, top_rows, row_ids, k, spilled=spilled,
                                             q_scales=q_scales if probe_bias is None else None)
        if return_rows:
            return top_s, top_i, top_rows
        return top_s, top_i


def ivf_search_grouped_probe(
    state: dict[str, Any],
    xq: torch.Tensor,
    k: int,
    *,
    nprobe: int,
    metric: str = "ip",
    int8_queries: bool = False,
    query_chunk: int | None = None,
    rescore: int | None = None,
    fold=probe_fold,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Grouped IVF probe through K1 (ip/cosine/l2); port of
    ``ivf_search_pallas`` (``pallas_ivf.py:648-761``).

    Requires a block-aligned index (``block_align`` a multiple of 512).
    ``residual_int8`` stores add the exact f32 coarse term q.c back per probe
    slot.  ``query_chunk`` probes the batch in slices to bound the candidate
    pool.  ``rescore`` widens the probe to that many candidates and exactly
    re-ranks them with f32 queries over reconstructed rows.
    Returns (distances, ids) with ids int32 and -1 for no hit.
    """
    meta = state["meta"]
    bl = int(meta.get("block_align", 0))
    if bl < 512 or bl % NBK != 0:
        raise ValueError(
            f"index must be built with block_align >= 512 (a multiple of {NBK}) "
            f"for the grouped probe; got {bl}"
        )
    nlist = int(meta["nlist"])
    window = int(meta["probe_window"])
    nprobe = max(1, min(nprobe, nlist))
    max_blocks = max(1, window // bl)
    vecs = state["ivf_vectors"]
    residual = meta.get("encoding") == "residual_int8" and vecs.dtype == torch.int8
    if residual and metric == "l2":
        raise ValueError("residual_int8 stores support ip/cosine only")

    squeeze = xq.ndim == 1
    if squeeze:
        xq = xq[None, :]
    with annotate("ivf.search", batch=xq.shape[0]):
        xq = xq.to(device=vecs.device, dtype=torch.float32)
        if vecs.shape[0] % bl != 0:
            raise ValueError(f"block-aligned IVF storage expected (rows % {bl} != 0)")
        b = xq.shape[0]
        step = max(1, b if query_chunk is None else query_chunk)
        parts = [
            _search_slice(state, xq[lo : lo + step], k, nprobe, metric, int8_queries, rescore, fold,
                          max_blocks, bl, residual)
            for lo in range(0, max(b, 1), step)
        ]
        if len(parts) == 1:
            dists, idx = parts[0]
        else:
            dists, idx = torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    if squeeze:
        return dists[0], idx[0]
    return dists, idx


def _search_slice(state, xq, k, nprobe, metric, int8_queries, rescore, fold, max_blocks, bl, residual):
    """One query slice of ``ivf_search_grouped_probe``."""
    meta = state["meta"]
    probe_lists = probe_bias = None
    if residual:
        with annotate("ivf.coarse"):
            probe_bias, probe_lists = flat_search(state["centroids"], xq, nprobe, metric=metric)
    do_rescore = rescore is not None and metric != "l2"
    k_probe = max(k, rescore) if do_rescore else k
    scores, idx = _grouped_probe(
        state["centroids"], state["ivf_vectors"], state["ivf_row_ids"], state["ivf_list_start"],
        state["ivf_list_size"], xq, state.get("ivf_row_scales"),
        ensure_norms_sq(state) if metric == "l2" else None,
        k_probe, nprobe, max_blocks, metric, int8_queries,
        probe_lists=probe_lists, probe_bias=probe_bias, packed_ok=do_rescore, bl=bl,
        spilled=float(meta.get("spill_frac", 0.0) or 0.0) > 0.0, fold=fold,
    )
    with annotate("ivf.rescore"):
        if do_rescore:
            scores, idx = rescore_candidates(state, xq, idx, k)
        dists = as_distance(scores, metric)
        if metric == "l2":
            q_norms = torch.sum(xq * xq, dim=-1, keepdim=True)
            dists = torch.where(idx == NO_HIT, torch.finfo(torch.float32).max, dists + q_norms)
    return dists, idx
