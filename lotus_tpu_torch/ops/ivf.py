"""IVF-Flat index: k-means coarse quantizer + inverted lists in sorted
(CSR-style), block-aligned storage.

Port of ``lotus_tpu/ops/ivf.py``: ``plan_block_aligned_layout`` (:31-74),
``build_ivf`` (:77-196), ``centroid_of_position`` / ``ensure_inv_perm`` /
``ensure_pos_list`` (:199-224), ``rescore_candidates`` (:227-285),
``load_ivf_state`` (:288-383) and the window probe ``_ivf_probe`` /
``ivf_search`` (:386-537), which serves stores that are not block-aligned
(and stores whose calibration dropped the grouped probe).  The on-disk layout
is the reference's, so an index built by either package loads in the other.
Block-aligned stores are probed by ``ops/ivf_probe.py``.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from lotus_tpu_torch.ops import io as index_io
from lotus_tpu_torch.ops.common import (
    MASK_SCORE, NO_HIT, as_distance, dedup_topk, require_full_f32, round_up,
)
from lotus_tpu_torch.ops.flat import flat_search
from lotus_tpu_torch.ops.kmeans import kmeans_assign, kmeans_assign_top2, kmeans_fit

# Max points used to train the coarse quantizer (~256 samples per centroid).
TRAIN_POINTS_PER_CENTROID = 256

# Transient device memory one window-probe step may allocate by default.  A
# config-4 store (10.5M x 768 residual int8 with its int4 refinement) holds
# about 15 GB on the card; 4 GiB of transients keeps the whole far inside an
# 80 GB H100, and a step of about a million gathered int8 rows is long enough
# that the per-step launches do not count.  It replaces the reference's
# ``vmem_budget_rows = 2**21`` (:483), which counted rows, not bytes, and
# only chunked queries: one config-4 query alone gathers 208 * window rows.
DEFAULT_GATHER_BUDGET_BYTES = 4 << 30


def default_device() -> torch.device:
    """The port's default device: the GPU.  Without one it raises rather
    than run on the CPU unasked; pass ``device="cpu"`` for that."""
    if not torch.cuda.is_available():
        raise RuntimeError('lotus_tpu_torch: no CUDA device; pass device="cpu" to run on the CPU')
    return torch.device("cuda")


def plan_block_aligned_layout(
    assign: np.ndarray, nlist: int, block_align: int, row_of_entry: np.ndarray | None = None
) -> dict[str, Any]:
    """Plan the block-aligned CSR layout from a list assignment (host-side).

    Every list starts at a multiple of ``block_align`` rows and occupies
    whole blocks; tail rows of each list's last block are padding (row id
    ``NO_HIT``).  Returns the geometry plus the scatter mapping ``order``
    (entries in assignment-sorted order) and ``dest`` (their storage
    positions): ``storage[dest] = vectors[order]``.  ``row_of_entry`` maps
    each entry to its logical row id (spilled rows appear twice).
    """
    n = assign.shape[0]
    order = np.argsort(assign, kind="stable")
    list_size = np.bincount(assign, minlength=nlist).astype(np.int32)
    max_list = int(list_size.max()) if nlist > 0 else 0

    padded_size = np.maximum(((list_size + block_align - 1) // block_align) * block_align, block_align)
    list_start = np.zeros(nlist, np.int32)
    list_start[1:] = np.cumsum(padded_size)[:-1]
    total = int(padded_size.sum())

    csum = np.zeros(nlist + 1, np.int64)
    csum[1:] = np.cumsum(list_size)
    rank_in_list = np.arange(n, dtype=np.int64) - csum[assign[order]]
    dest = list_start.astype(np.int64)[assign[order]] + rank_in_list

    row_ids = np.full(total, NO_HIT, np.int32)
    row_ids[dest] = order if row_of_entry is None else row_of_entry[order]
    window = max(block_align, int(((max_list + block_align - 1) // block_align) * block_align))
    return {
        "order": order,
        "dest": dest,
        "row_ids": row_ids,
        "list_start": list_start,
        "list_size": list_size,
        "max_list": max_list,
        "window": window,
        "total": total,
    }


def build_ivf(
    index_dir: str,
    emb: np.ndarray,
    *,
    nlist: int,
    metric: str,
    train_iters: int = 10,
    seed: int = 0,
    block_align: int | None = None,
    spill_frac: float = 0.0,
    device: torch.device | str | None = None,
) -> dict[str, Any]:
    """Train the coarse quantizer, assign, sort, persist. Returns the meta patch.

    With ``block_align`` set, every list starts at a multiple of that many
    rows and occupies whole blocks — the layout the grouped probe needs.
    ``spill_frac`` > 0 also stores that fraction of rows (the smallest top-2
    centroid margins) in their second list; it requires ``block_align``.
    k-means runs on ``device`` (default: the GPU; ``default_device``).
    """
    dev = torch.device(device) if device is not None else default_device()
    n, d = emb.shape
    nlist = min(nlist, n)

    max_train = TRAIN_POINTS_PER_CENTROID * nlist
    if n > max_train:
        sel = np.random.default_rng(seed).choice(n, size=max_train, replace=False)
        sel.sort()
        train_x = torch.as_tensor(np.asarray(emb[sel], np.float32), device=dev)
    else:
        train_x = torch.as_tensor(np.asarray(emb, np.float32), device=dev)

    gen = torch.Generator(device=dev).manual_seed(seed)
    res = kmeans_fit(train_x, nlist, iters=train_iters, metric="l2", spherical=(metric != "l2"), generator=gen)
    centroids = res.centroids.float().cpu().numpy()
    del train_x

    if spill_frac > 0 and not block_align:
        raise ValueError("spill_frac requires a block-aligned build")

    # Assign by the index metric so probe-time coarse ranking is consistent.
    cent_dev = torch.as_tensor(centroids, device=dev)
    assign = np.empty(n, np.int32)
    assign2 = np.empty(n, np.int32) if spill_frac > 0 else None
    margins = np.empty(n, np.float32) if spill_frac > 0 else None
    chunk_rows = max(1, (1 << 31) // max(d * 4, 1))  # ~2 GB of f32 rows per pass
    for s in range(0, n, chunk_rows):
        x_dev = torch.as_tensor(np.asarray(emb[s : s + chunk_rows], np.float32), device=dev)
        if spill_frac > 0:
            a1, a2, mg = kmeans_assign_top2(x_dev, cent_dev, metric=metric)
            assign[s : s + chunk_rows] = a1.cpu().numpy()
            assign2[s : s + chunk_rows] = a2.cpu().numpy()
            margins[s : s + chunk_rows] = mg.cpu().numpy()
        else:
            a, _ = kmeans_assign(x_dev, cent_dev, metric=metric)
            assign[s : s + chunk_rows] = a.cpu().numpy()
    del cent_dev

    if block_align:
        if spill_frac > 0:
            tau = float(np.quantile(margins, spill_frac))
            spill_rows = np.where(margins <= tau)[0]
            entry_assign = np.concatenate([assign, assign2[spill_rows]])
            row_of_entry = np.concatenate([np.arange(n, dtype=np.int64), spill_rows]).astype(np.int32)
        else:
            entry_assign, row_of_entry = assign, None
        plan = plan_block_aligned_layout(entry_assign, nlist, block_align, row_of_entry)
        list_start, list_size = plan["list_start"], plan["list_size"]
        row_ids, window = plan["row_ids"], plan["window"]
        order, dest = plan["order"], plan["dest"]
        src_rows = order if row_of_entry is None else row_of_entry[order]
        sorted_vecs = np.zeros((plan["total"], d), np.float32)
        chunk = max(1, (1 << 28) // max(d * 4, 1))  # ~256 MB of rows per pass
        for s in range(0, len(src_rows), chunk):
            sorted_vecs[dest[s : s + chunk]] = emb[src_rows[s : s + chunk]]
        max_list = plan["max_list"]
    else:
        order = np.argsort(assign, kind="stable")
        list_size = np.bincount(assign, minlength=nlist).astype(np.int32)
        max_list = int(list_size.max()) if nlist > 0 else 0
        sorted_vecs = emb[order]
        row_ids = order.astype(np.int32)
        list_start = np.zeros(nlist, np.int32)
        list_start[1:] = np.cumsum(list_size)[:-1]
        window = max(1, round_up(max_list, 8))

    # Pad storage so start + window never reads out of bounds.
    pad = window
    sorted_vecs = np.concatenate([sorted_vecs, np.zeros((pad, d), np.float32)])
    row_ids = np.concatenate([row_ids, np.full(pad, NO_HIT, np.int32)])

    index_io.write_array(index_dir, "ivf_centroids", centroids)
    index_io.write_array(index_dir, "ivf_vectors", np.asarray(sorted_vecs, dtype=np.float32))
    index_io.write_array(index_dir, "ivf_row_ids", row_ids)
    index_io.write_array(index_dir, "ivf_list_start", list_start)
    index_io.write_array(index_dir, "ivf_list_size", list_size)
    return {
        "nlist": int(nlist),
        "max_list_size": max_list,
        "probe_window": int(window),
        "block_align": int(block_align) if block_align else 0,
        "spill_frac": float(spill_frac),
    }


def centroid_of_position(list_start: torch.Tensor, total_rows: int) -> torch.Tensor:
    """List id of every storage position (CSR lists are start-sorted), int32."""
    pos = torch.arange(total_rows, dtype=list_start.dtype, device=list_start.device)
    return (torch.searchsorted(list_start, pos, right=True) - 1).clamp_(min=0).to(torch.int32)


def ensure_inv_perm(state: dict[str, Any]) -> torch.Tensor:
    """original-row-id -> one storage position (cached in the state, int32).

    A spilled row is stored twice; like the reference's numpy assignment, it
    maps to its last position in storage order, the copy whose residual the
    int4 refinement encodes (``load_ivf_state`` writes it last-wins too).  An
    index assignment would leave the choice to the backend."""
    if "ivf_inv_perm" not in state:
        storage_ids = state["ivf_row_ids"]
        live_pos = torch.nonzero(storage_ids >= 0).squeeze(1)
        n_rows = int(storage_ids.max()) + 1 if live_pos.numel() else 0
        inv = torch.zeros(max(n_rows, 1), dtype=torch.int64, device=storage_ids.device)
        inv.scatter_reduce_(0, storage_ids[live_pos].long(), live_pos, reduce="amax")
        state["ivf_inv_perm"] = inv.to(torch.int32)
    return state["ivf_inv_perm"]


def ensure_pos_list(state: dict[str, Any]) -> torch.Tensor:
    """storage position -> owning list id (cached in the state, int32)."""
    if "ivf_pos_list" not in state:
        state["ivf_pos_list"] = centroid_of_position(
            state["ivf_list_start"], int(state["ivf_vectors"].shape[0])
        )
    return state["ivf_pos_list"]


def ensure_norms_sq(state: dict[str, Any]) -> torch.Tensor:
    """Squared row norms of the storage (cached in the state): l2 scoring's
    ||x||^2.  int8 stores get them at load time from the quantized rows;
    float stores square their rows here, as the reference's probes do."""
    if "ivf_norms_sq" not in state:
        vf = state["ivf_vectors"].float()
        state["ivf_norms_sq"] = torch.sum(vf * vf, dim=-1)
    return state["ivf_norms_sq"]


def _rescore_impl(xq, cand_i, cand_rows, vecs, scales, refine, refine_scales, pos_list, centroids, k):
    """Exact f32 rescoring of a small candidate set (ip/cosine): rebuild each
    candidate from int8 (+ packed-int4 refinement, + list centroid on
    residual stores) and re-rank with full-precision queries."""
    rows = cand_rows.long()
    v = vecs[rows].float()
    if scales is not None:  # float stores rescore without dequantization
        v = v * scales[rows][..., None]
    if refine is not None:
        from lotus_tpu_torch.ops.quant import unpack_int4

        # Refinement is keyed by ORIGINAL row id; it refines the primary copy.
        rid = torch.clamp(cand_i, min=0).long()
        v = v + unpack_int4(refine[rid]).float() * refine_scales[rid][..., None]
    if pos_list is not None:
        v = v + centroids[pos_list[rows].long()]
    s = torch.einsum("qd,qmd->qm", xq, v)
    s = torch.where(cand_i == NO_HIT, torch.full_like(s, MASK_SCORE), s)
    top_s, pos = torch.topk(s, min(k, s.shape[1]), dim=1)
    return top_s, torch.gather(cand_i, 1, pos)


def rescore_candidates(
    state: dict[str, Any], xq: torch.Tensor, cand_i: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact-rescore probe candidates (original row ids) down to top-k."""
    residual = state["meta"].get("encoding") == "residual_int8"
    inv = ensure_inv_perm(state)
    rows = inv[torch.clamp(cand_i, min=0).long()]
    return _rescore_impl(
        xq.float(), cand_i, rows,
        state["ivf_vectors"], state.get("ivf_row_scales"),
        state.get("ivf_refine"), state.get("ivf_refine_scales"),
        ensure_pos_list(state) if residual else None,
        state["centroids"] if residual else None,
        k,
    )


def load_ivf_state(
    index_dir: str,
    meta: dict[str, Any],
    dtype: torch.dtype,
    refine_int4: bool | None = None,
    device: torch.device | str | None = None,
) -> dict[str, Any]:
    """Load (and for int8, quantize) the IVF arrays onto ``device`` (default:
    the GPU; ``default_device``).

    int8 quantization runs on the host in numpy exactly as the reference's
    does (round half to even), chunked so a 10M x 768 store never needs a
    second float copy in RAM; the result then moves to the device.
    ``residual_int8`` stores quantize (vec - list centroid) and fall back to
    plain int8 when residuals are no smaller than the raw vectors.
    """

    device = torch.device(device) if device is not None else default_device()

    def wrap(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    state: dict[str, Any] = {
        "centroids": wrap(index_io.read_array(index_dir, "ivf_centroids", mmap=False)),
        "ivf_row_ids": wrap(index_io.read_array(index_dir, "ivf_row_ids", mmap=False)),
        "ivf_list_start": wrap(index_io.read_array(index_dir, "ivf_list_start", mmap=False)),
        "ivf_list_size": wrap(index_io.read_array(index_dir, "ivf_list_size", mmap=False)),
    }
    vecs = index_io.read_array(index_dir, "ivf_vectors")  # f32 mmap
    if vecs.dtype == np.int8:  # written by save_ivf_state: loaded as it was built
        return _load_quantized(index_dir, meta, dtype, refine_int4, state, wrap)
    if dtype != torch.int8:
        state["ivf_vectors"] = torch.from_numpy(np.array(vecs, np.float32)).to(device=device, dtype=dtype)
        return state

    residual = meta.get("encoding") == "residual_int8" and meta.get("metric") != "l2"
    n = vecs.shape[0]
    q = np.empty(vecs.shape, np.int8)
    scales = np.empty(n, np.float32)
    if residual:
        cents = np.asarray(index_io.read_array(index_dir, "ivf_centroids", mmap=False), np.float32)
        starts = np.asarray(index_io.read_array(index_dir, "ivf_list_start", mmap=False))
        row_ids_np = np.asarray(index_io.read_array(index_dir, "ivf_row_ids", mmap=False))
        pos_list = centroid_of_position(torch.from_numpy(starts), n).numpy()
        # Residual coding only helps when rows sit close to their centroid:
        # on a sample, compare the residual's per-row maxabs (the int8 step)
        # against the raw vector's; fall back to plain int8 when residuals
        # are no smaller.  The state carries the decision in "meta".
        live_pos = np.nonzero(row_ids_np >= 0)[0]
        sample = live_pos[:: max(1, len(live_pos) // 4096)][:4096]
        sv = np.asarray(vecs[sample], np.float32)
        raw_step = np.abs(sv).max(axis=1).mean()
        res_step = np.abs(sv - cents[pos_list[sample]]).max(axis=1).mean()
        if res_step >= raw_step * 0.9:
            residual = False
            state["meta"] = {**meta, "encoding": "int8"}
    refine = bool(refine_int4 if refine_int4 is not None else meta.get("refine_int4", False))
    refine = refine and meta.get("metric") != "l2"
    if refine:
        row_ids_all = np.asarray(index_io.read_array(index_dir, "ivf_row_ids", mmap=False))
        n_rows = int(row_ids_all.max()) + 1
        r4 = np.zeros((n_rows, vecs.shape[1] // 2), np.int8)
        r4s = np.zeros(n_rows, np.float32)
    step = 1 << 20
    for s in range(0, n, step):
        block = np.asarray(vecs[s : s + step], dtype=np.float32)
        if residual:
            live = (row_ids_np[s : s + step] >= 0)[:, None]
            block = np.where(live, block - cents[pos_list[s : s + step]], 0.0)
        m = np.abs(block).max(axis=1)
        sc = np.where(m > 0, m / 127.0, 1.0).astype(np.float32)
        q[s : s + step] = np.clip(np.rint(block / sc[:, None]), -127, 127).astype(np.int8)
        scales[s : s + step] = sc
        if refine:
            # Packed-int4 refinement of the int8 quantization residual,
            # keyed by ORIGINAL row id (spilled copies share one entry).
            rid = row_ids_all[s : s + step]
            live_rows = rid >= 0
            r2 = block - q[s : s + step].astype(np.float32) * sc[:, None]
            m4 = np.abs(r2).max(axis=1)
            s4 = np.where(m4 > 0, m4 / 7.0, 1.0).astype(np.float32)
            q4 = np.clip(np.rint(r2 / s4[:, None]), -7, 7).astype(np.int8)
            packed = ((q4[:, 0::2] & 0xF) | ((q4[:, 1::2] & 0xF) << 4)).astype(np.int8)
            r4[rid[live_rows]] = packed[live_rows]
            r4s[rid[live_rows]] = s4[live_rows]
    state["ivf_vectors"] = wrap(q)
    state["ivf_row_scales"] = wrap(scales)
    if refine:
        state["ivf_refine"] = wrap(r4)
        state["ivf_refine_scales"] = wrap(r4s)
    if meta.get("metric") == "l2":
        norms = (q.astype(np.float32) ** 2).sum(axis=1) * scales.astype(np.float64) ** 2
        state["ivf_norms_sq"] = wrap(norms.astype(np.float32))
    return state


# The arrays of a quantized state that save_ivf_state writes beside the
# reference's four (centroids, row ids, list starts and sizes).
QUANTIZED_ARRAYS = ("ivf_vectors", "ivf_row_scales", "ivf_inv_perm", "ivf_refine", "ivf_refine_scales")


def save_ivf_state(index_dir: str, state: dict[str, Any]) -> None:
    """Write a built int8 IVF state (``synth_ivf_device_build``'s) as an
    index directory that ``TorchVS`` loads: its int8 rows, scales and int4
    refinement as they were built, so a load never quantizes again (as
    ``parallel/ivf.py::save_ivf_shards`` keeps a shard's).  The directory
    holds no f32 ``vectors``: the store serves searches with and without
    ``ids``, but what reads the unquantized rows (``get_vectors_from_index``,
    the exhaustive scan route, calibration) fails on it, and the reference's
    ``TpuVS`` cannot load it."""
    meta = state["meta"]
    if state["ivf_vectors"].dtype != torch.int8:
        raise ValueError("save_ivf_state writes int8 states only")
    index_io.write_array(index_dir, "ivf_centroids", state["centroids"].cpu().numpy())
    for name in ("ivf_row_ids", "ivf_list_start", "ivf_list_size", *QUANTIZED_ARRAYS):
        if name in state:
            index_io.write_array(index_dir, name, state[name].cpu().numpy())
    index_io.write_meta(index_dir, {
        "kind": "ivf", "metric": meta["metric"], "n_rows": int(meta["n"]), "dim": int(meta["d"]),
        "device_dtype": "int8", "encoding": meta.get("encoding", "int8"), "refine_int4": "ivf_refine" in state,
        **{key: meta[key] for key in ("nlist", "max_list_size", "probe_window", "block_align", "spill_frac")},
    })


def _load_quantized(index_dir, meta, dtype, refine_int4, state, wrap) -> dict[str, Any]:
    """``load_ivf_state`` of a directory ``save_ivf_state`` wrote."""
    if dtype != torch.int8:
        raise ValueError(f"{index_dir} holds int8 rows; load it as int8, not {dtype}")
    refine = bool(refine_int4 if refine_int4 is not None else meta.get("refine_int4", False))
    for name in QUANTIZED_ARRAYS:
        wanted = refine or name not in ("ivf_refine", "ivf_refine_scales")
        if wanted and os.path.exists(os.path.join(index_dir, f"{name}.npy")):
            state[name] = wrap(index_io.read_array(index_dir, name, mmap=False))
    if refine and "ivf_refine" not in state:
        raise ValueError(f"{index_dir} holds no int4 refinement")
    if meta.get("metric") == "l2":
        state["ivf_norms_sq"] = (state["ivf_vectors"].float() ** 2).sum(1) * state["ivf_row_scales"] ** 2
    return state


def window_row_bytes(d: int, store_dtype: torch.dtype) -> int:
    """Transient bytes one gathered row costs a window-probe step: the row in
    the store's dtype, its f32 copy for the product (int8 and bf16 stores),
    and five per-row planes: the int32 storage row, the bool mask, the f32
    scores, one gathered f32 factor (the row scale or norm) and top-k's
    workspace."""
    esize = torch.empty((), dtype=store_dtype).element_size()
    cast = 4 * d if store_dtype != torch.float32 else 0
    return d * esize + cast + 4 + 1 + 4 + 4 + 4


def plan_window_probe(
    b: int, nprobe: int, window: int, d: int, store_dtype: torch.dtype, budget: int
) -> tuple[int, int, int]:
    """How the window probe cuts a batch so that no step allocates more than
    ``budget`` bytes: ``(query_chunk, slot_group, step_bytes)``.

    A step gathers ``query_chunk * slot_group * window`` rows.  Queries are
    chunked while one query's whole slab fits; when it does not, each query
    runs alone and its probe slots are cut into groups of ``slot_group``.
    Raises ``ValueError`` when the budget cannot hold one slot of one query.
    """
    per_slot = window * window_row_bytes(d, store_dtype)
    if per_slot > budget:
        raise ValueError(
            f"gather_budget_bytes={budget:,} cannot hold one probe slot of one query "
            f"({window} rows, {per_slot:,} bytes)"
        )
    per_query = nprobe * per_slot
    if per_query <= budget:
        query_chunk, slot_group = max(1, min(b, budget // per_query)), nprobe
    else:
        query_chunk, slot_group = 1, budget // per_slot
    return query_chunk, slot_group, query_chunk * slot_group * per_slot


def _ivf_probe(
    centroids: torch.Tensor,
    xb_sorted: torch.Tensor,
    row_ids: torch.Tensor,
    list_start: torch.Tensor,
    list_size: torch.Tensor,
    xq: torch.Tensor,
    k: int,
    nprobe: int,
    window: int,
    metric: str,
    query_chunk: int,
    slot_group: int,
    row_scales: torch.Tensor | None = None,
    norms_sq: torch.Tensor | None = None,
    residual: bool = False,
    owned: torch.Tensor | None = None,
    return_rows: bool = False,
):
    """The window probe (``ivf.py:386-473``): per query, gather a window of
    rows from each of its ``nprobe`` nearest lists, mask the tail of each list,
    score, top-k and keep each id's best copy.

    A shard (``parallel/ivf.py::sharded_ivf_search``) passes ``owned``, its
    (nlist,) bool list mask: rows of lists it does not own are masked too.
    ``return_rows`` adds the storage rows of the top-k as a third output.

    int8 and bf16 stores compute with bf16 operands and f32 sums (bf16
    products are exact in f32, so f32 products of the rounded operands are
    the reference's); f32 stores compute in f32 (no TF32).  Steps of
    ``query_chunk`` queries by ``slot_group`` probe slots each keep their
    top-kc; the top-kc of their union is the top-kc over all slots.
    """
    b, d = xq.shape
    dev = xq.device
    require_full_f32(xq)
    # Coarse ranking: nearest nprobe centroids per query.  For residual
    # stores the coarse similarities double as the exact q.c score term.
    coarse_s, probe_lists = flat_search(centroids, xq, nprobe, metric=metric)
    if xb_sorted.dtype in (torch.int8, torch.bfloat16):
        xq = xq.to(torch.bfloat16).float()
    offsets = torch.arange(window, dtype=torch.int32, device=dev)
    kc = min(2 * k, nprobe * window)
    if owned is not None:
        list_size = torch.where(owned, list_size, torch.zeros_like(list_size))
    out_s, out_i, out_r = [], [], []
    for lo in range(0, b, query_chunk):
        q = xq[lo : lo + query_chunk]
        qc = q.shape[0]
        lists = probe_lists[lo : lo + query_chunk].long()
        starts, sizes = list_start[lists], list_size[lists]  # (qc, nprobe)
        part_s, part_r = [], []
        for s0 in range(0, nprobe, slot_group):
            s1 = min(s0 + slot_group, nprobe)
            rows = (starts[:, s0:s1, None] + offsets).view(-1)  # (qc * g * W,) int32
            gathered = xb_sorted.index_select(0, rows)
            if gathered.dtype != torch.float32:
                gathered = gathered.float()
            sims = torch.bmm(gathered.view(qc, -1, d), q.unsqueeze(2)).view(qc, -1)
            del gathered
            if row_scales is not None:
                # Dequantize at the score level: int8 rows factor their scale
                # out of the dot product.
                sims.mul_(row_scales.index_select(0, rows).view(qc, -1))
            if residual:
                # Every candidate of probe slot s owes q.c of that slot's list.
                sims.view(qc, s1 - s0, window).add_(coarse_s[lo : lo + qc, s0:s1, None])
            if metric == "l2":
                sims.mul_(2.0).sub_(norms_sq.index_select(0, rows).view(qc, -1))
            sims.masked_fill_((offsets >= sizes[:, s0:s1, None]).view(qc, -1), MASK_SCORE)
            top_s, pos = torch.topk(sims, min(kc, sims.shape[1]), dim=1)
            part_s.append(top_s)
            part_r.append(torch.gather(rows.view(qc, -1), 1, pos))
            del sims
        top_s, top_r = torch.cat(part_s, 1), torch.cat(part_r, 1)
        if len(part_s) > 1:
            top_s, pos = torch.topk(top_s, kc, dim=1)
            top_r = torch.gather(top_r, 1, pos)
        # 2k head-room, then drop duplicate row ids (spilled rows can appear
        # through two probed lists) keeping each id's best-scored copy.
        top_ids = row_ids[top_r.long()]
        top_ids = torch.where(top_s <= MASK_SCORE / 2, torch.full_like(top_ids, NO_HIT), top_ids)
        s, i, r = dedup_topk(top_s, top_ids, k, aux=top_r)
        out_s.append(s)
        out_i.append(i)
        out_r.append(r)
    if return_rows:
        return torch.cat(out_s), torch.cat(out_i), torch.cat(out_r)
    return torch.cat(out_s), torch.cat(out_i)


def ivf_search(
    state: dict[str, Any],
    xq: torch.Tensor,
    k: int,
    *,
    nprobe: int,
    metric: str,
    gather_budget_bytes: int = DEFAULT_GATHER_BUDGET_BYTES,
    rescore: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Search the IVF index through the window probe. Returns (distances,
    original-row ids), ids int32 and -1 for no hit.

    ``gather_budget_bytes`` bounds the transient memory of each step: 4 GiB
    by default, which fits beside a config-4 store on an 80 GB card (see
    ``DEFAULT_GATHER_BUDGET_BYTES`` and ``plan_window_probe``).  It raises
    rather than exceed it, and never moves the work off the state's device.
    ``rescore`` widens the probe to that many candidates and exactly
    re-ranks them with f32 queries over reconstructed rows (int8 stores,
    ip/cosine; see ``rescore_candidates``).  Runs on the device that holds
    the state.
    """
    meta = state["meta"]
    nlist = int(meta["nlist"])
    window = int(meta["probe_window"])
    nprobe = max(1, min(nprobe, nlist))
    vecs = state["ivf_vectors"]
    # Residual scoring applies only when storage really is int8 residuals
    # (an f32 load of the same index stores the raw vectors).
    residual = meta.get("encoding") == "residual_int8" and vecs.dtype == torch.int8
    if residual and metric == "l2":
        raise ValueError("residual_int8 stores support ip/cosine only")

    squeeze = xq.ndim == 1
    if squeeze:
        xq = xq[None, :]
    xq = xq.to(device=vecs.device, dtype=torch.float32)
    query_chunk, slot_group, _ = plan_window_probe(
        xq.shape[0], nprobe, window, vecs.shape[1], vecs.dtype, gather_budget_bytes
    )
    do_rescore = rescore is not None and metric != "l2" and vecs.dtype == torch.int8
    k_probe = max(k, rescore) if do_rescore else k
    scores, idx = _ivf_probe(
        state["centroids"], vecs, state["ivf_row_ids"], state["ivf_list_start"], state["ivf_list_size"],
        xq, k_probe, nprobe, window, metric, query_chunk, slot_group,
        state.get("ivf_row_scales"), ensure_norms_sq(state) if metric == "l2" else None,
        residual=residual,
    )
    if do_rescore:
        scores, idx = rescore_candidates(state, xq, idx, k)
    dists = as_distance(scores, metric)
    if metric == "l2":
        q_norms = torch.sum(xq * xq, dim=-1, keepdim=True)
        dists = torch.where(idx == NO_HIT, torch.finfo(torch.float32).max, dists + q_norms)
    if squeeze:
        return dists[0], idx[0]
    return dists, idx
