"""IVF-Flat index: k-means coarse quantizer + inverted lists in sorted
(CSR-style), block-aligned storage.

Port of ``lotus_tpu/ops/ivf.py``: ``plan_block_aligned_layout`` (:31-74),
``build_ivf`` (:77-196), ``centroid_of_position`` / ``ensure_inv_perm`` /
``ensure_pos_list`` (:199-224), ``rescore_candidates`` (:227-285) and
``load_ivf_state`` (:288-383).  The on-disk layout is the reference's, so an
index built by either package loads in the other.  The window probe
(``_ivf_probe`` / ``ivf_search``) is not ported yet; block-aligned stores are
probed by ``ops/ivf_probe.py``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from lotus_tpu_torch.ops import io as index_io
from lotus_tpu_torch.ops.common import MASK_SCORE, NO_HIT, round_up
from lotus_tpu_torch.ops.kmeans import kmeans_assign, kmeans_assign_top2, kmeans_fit

# Max points used to train the coarse quantizer (~256 samples per centroid).
TRAIN_POINTS_PER_CENTROID = 256


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
    """original-row-id -> one storage position (cached in the state, int32)."""
    if "ivf_inv_perm" not in state:
        storage_ids = state["ivf_row_ids"]
        live_pos = torch.nonzero(storage_ids >= 0).squeeze(1)
        n_rows = int(storage_ids.max()) + 1 if live_pos.numel() else 0
        inv = torch.zeros(max(n_rows, 1), dtype=torch.int32, device=storage_ids.device)
        inv[storage_ids[live_pos].long()] = live_pos.to(torch.int32)
        state["ivf_inv_perm"] = inv
    return state["ivf_inv_perm"]


def ensure_pos_list(state: dict[str, Any]) -> torch.Tensor:
    """storage position -> owning list id (cached in the state, int32)."""
    if "ivf_pos_list" not in state:
        state["ivf_pos_list"] = centroid_of_position(
            state["ivf_list_start"], int(state["ivf_vectors"].shape[0])
        )
    return state["ivf_pos_list"]


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
