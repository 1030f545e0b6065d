"""Sharded IVF-Flat: inverted lists spread over the ranks of a mesh, probed
locally, merged with one all-gather.

Port of ``lotus_tpu/parallel/ivf.py`` (BASELINE config 5).  Lists go to
ranks in contiguous, row-balanced ranges; centroids and list sizes are
replicated.  Every rank ranks all centroids for the queries, probes only the
lists it owns (the others are masked), keeps k candidates per query, and
the (B, k) candidates of all ranks are all-gathered, so every rank computes
the same final merge.

The shard plan is the reference's bit for bit.  It runs on the state's own
device, one shard at a time, so a card-resident config-4 store is planned
and written without a host copy of the whole; ``plan_ivf_shards`` returns
numpy arrays as the reference's does.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from lotus_tpu_torch.ops import io as index_io
from lotus_tpu_torch.ops.common import MASK_SCORE, NO_HIT, as_distance, dedup_topk, require_full_f32, round_up
from lotus_tpu_torch.ops.flat import flat_search
from lotus_tpu_torch.ops.ivf import (
    DEFAULT_GATHER_BUDGET_BYTES,
    _ivf_probe,
    centroid_of_position,
    plan_window_probe,
)
from lotus_tpu_torch.ops.ivf_probe import NBK, _grouped_probe
from lotus_tpu_torch.parallel.mesh import SHARD_AXIS, ShardMesh

_DTYPE_NAMES = {torch.int8: "int8", torch.float32: "float32", torch.float16: "float16",
                torch.bfloat16: "bfloat16"}


def _tensor(a: Any) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))


def _plan_geometry(state: dict[str, Any], n_shards: int) -> dict[str, Any]:
    """The plan's host-side part: each shard's list range, storage row range
    and local list starts, and the common padded row count."""
    starts = _tensor(state["ivf_list_start"]).cpu().numpy()
    sizes = _tensor(state["ivf_list_size"]).cpu().numpy()
    nlist = len(sizes)

    # Contiguous list ranges with balanced row counts (parallel/ivf.py:44-55).
    total = int(sizes.sum())
    target = total / n_shards
    bounds = [0]
    acc = 0
    for li in range(nlist):
        acc += int(sizes[li])
        if acc >= target * len(bounds) and len(bounds) < n_shards:
            bounds.append(li + 1)
    while len(bounds) < n_shards + 1:
        bounds.append(nlist)
    bounds[-1] = nlist

    per_dev = []
    max_rows = 0
    window = int(state["meta"]["probe_window"])
    for d in range(n_shards):
        lo, hi = bounds[d], bounds[d + 1]
        row_lo = int(starts[lo]) if hi > lo else 0
        row_hi = int(starts[hi - 1] + sizes[hi - 1]) if hi > lo else 0
        local_start = np.zeros(nlist, np.int32)
        owned = np.zeros(nlist, bool)
        if hi > lo:
            local_start[lo:hi] = starts[lo:hi] - row_lo
            owned[lo:hi] = True
        per_dev.append((row_lo, row_hi, local_start, owned))
        max_rows = max(max_rows, row_hi - row_lo)
    # Window overshoot room; block-aligned builds keep every shard's row
    # count a multiple of the block so the grouped probe runs per shard.
    align = max(8, int(state["meta"].get("block_align", 0)) or 8)
    max_rows = round_up(max_rows + window, align)
    meta = {"n_shards": n_shards, "max_rows": int(max_rows), "bounds": [int(b) for b in bounds]}
    return {"meta": meta, "per_dev": per_dev, "max_rows": max_rows}


def _shard_arrays(state: dict[str, Any], geo: dict[str, Any], sid: int) -> dict[str, torch.Tensor]:
    """Shard ``sid``'s equal-shape arrays (``vecs``, ``row_ids``,
    ``list_start``, ``owned``, ``row_list``, optionally ``scales`` and
    ``norms``), built on the device of the state's vectors."""
    vectors = _tensor(state["ivf_vectors"])
    dev = vectors.device
    row_lo, row_hi, local_start, owned = geo["per_dev"][sid]
    max_rows, m = geo["max_rows"], row_hi - row_lo
    vecs = torch.zeros((max_rows, vectors.shape[1]), dtype=vectors.dtype, device=dev)
    vecs[:m] = vectors[row_lo:row_hi]
    ids = torch.full((max_rows,), NO_HIT, dtype=torch.int32, device=dev)
    ids[:m] = _tensor(state["ivf_row_ids"])[row_lo:row_hi].to(dev)
    # Each storage row's list id, for the shard-local residual rebuild
    # during exact rescoring: from the global CSR layout.
    starts = _tensor(state["ivf_list_start"]).to(dev)
    row_list = torch.zeros((max_rows,), dtype=torch.int32, device=dev)
    row_list[:m] = centroid_of_position(starts, vectors.shape[0])[row_lo:row_hi]
    shard = {
        "vecs": vecs,
        "row_ids": ids,
        "list_start": torch.from_numpy(local_start).to(dev),
        "owned": torch.from_numpy(owned).to(dev),
        "row_list": row_list,
    }
    for name, key in (("scales", "ivf_row_scales"), ("norms", "ivf_norms_sq")):
        if key in state:
            plane = torch.zeros((max_rows,), dtype=torch.float32, device=dev)
            plane[:m] = _tensor(state[key])[row_lo:row_hi].to(dev)
            shard[name] = plane
    return shard


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    # numpy has no bfloat16: such rows are written as their 16-bit patterns,
    # and the manifest's vec_dtype says how to read them back.
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


def plan_ivf_shards(state: dict[str, Any], n_shards: int) -> tuple[dict[str, Any], list[dict[str, np.ndarray]]]:
    """Shard plan: contiguous list ranges with balanced row counts.

    Returns ``(plan_meta, shards)``: per shard a dict of equal-shape numpy
    arrays (``vecs``, ``row_ids``, ``list_start``, ``owned``, ``row_list``,
    optionally ``scales`` / ``norms``) padded to a common ``max_rows``, equal
    to ``lotus_tpu.parallel.plan_ivf_shards``'s for the same state.
    """
    geo = _plan_geometry(state, n_shards)
    shards = [{k: _to_numpy(v) for k, v in _shard_arrays(state, geo, sid).items()} for sid in range(n_shards)]
    return geo["meta"], shards


def _place(
    arrays: dict[str, torch.Tensor], mesh: ShardMesh, axis_name: str, meta: dict[str, Any],
    centroids: torch.Tensor, list_size: torch.Tensor,
) -> dict[str, Any]:
    dev = mesh.device
    out: dict[str, Any] = {
        "meta": meta,
        "centroids": centroids.to(dev),  # replicated
        "list_size": list_size.to(dev),  # replicated
        "mesh": mesh,
        "axis_name": axis_name,
    }
    out.update({k: v.to(dev) for k, v in arrays.items()})
    return out


def shard_ivf_state(state: dict[str, Any], mesh: ShardMesh, axis_name: str = SHARD_AXIS) -> dict[str, Any]:
    """This rank's shard of a loaded IVF state (``ops/ivf.py::load_ivf_state``),
    on the mesh's device: the plan's arrays for ``mesh.slot`` with the
    replicated centroids and list sizes.  A state's int4 refinement stays
    out, as in the reference's shards."""
    geo = _plan_geometry(state, mesh.shape[axis_name])
    arrays = _shard_arrays(state, geo, mesh.slot)
    return _place(arrays, mesh, axis_name, state["meta"], _tensor(state["centroids"]),
                  _tensor(state["ivf_list_size"]))


def save_ivf_shards(index_dir: str, state: dict[str, Any], num_shards: int) -> None:
    """Persist a loaded (possibly quantized) IVF state as per-host shards.

    The config-5 lifecycle: one process builds and writes ``shard_<i>/``
    slices and the manifest; at serve time every rank reads only its own
    (``load_sharded_ivf_state``).  Quantized states persist their int8 rows
    and scales, so a reload never quantizes again.  Shards are built one at
    a time on the state's device and written from the host.
    """
    from lotus_tpu_torch.parallel.distributed import save_index_shards

    geo = _plan_geometry(state, num_shards)
    vecs = _tensor(state["ivf_vectors"])
    shard_meta = {
        **geo["meta"],
        "vec_dtype": _DTYPE_NAMES[vecs.dtype],
        "encoding": state["meta"].get("encoding", ""),
    }
    for sid in range(num_shards):
        arrays = {k: _to_numpy(v) for k, v in _shard_arrays(state, geo, sid).items()}
        save_index_shards(index_dir, arrays, shard_id=sid, num_shards=num_shards, meta=shard_meta)
        del arrays


def load_sharded_ivf_state(
    index_dir: str,
    meta: dict[str, Any],
    mesh: ShardMesh,
    axis_name: str = SHARD_AXIS,
) -> dict[str, Any]:
    """Load this rank's shard and the replicated arrays onto its device.

    Each rank reads only its own shard files: a 100M-row store never passes
    through one host, and the monolithic arrays never reach the card.
    Requires a manifest written by ``save_ivf_shards`` (of either package)
    with one shard per mesh slot.
    """
    from lotus_tpu_torch.parallel.distributed import load_index_shard, shard_manifest

    manifest = shard_manifest(index_dir)
    n_dev = mesh.shape[axis_name]
    if int(manifest["num_shards"]) != n_dev:
        raise ValueError(
            f"index has {manifest['num_shards']} shards but the mesh has {n_dev} "
            f"ranks along {axis_name!r}; rebuild or resize the mesh"
        )
    mmeta = manifest.get("meta", {})
    arrays = {}
    for name, arr in load_index_shard(index_dir, mesh.slot, mmap=False).items():
        t = torch.from_numpy(arr)
        if name == "vecs" and mmeta.get("vec_dtype") == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        arrays[name] = t
    # The quantization pass may have downgraded residual -> plain int8 when
    # residuals were no smaller (load_ivf_state's sample check); the manifest
    # records the encoding the persisted rows use.
    if mmeta.get("encoding"):
        meta = {**meta, "encoding": mmeta["encoding"]}
    centroids = torch.from_numpy(index_io.read_array(index_dir, "ivf_centroids", mmap=False))
    list_size = torch.from_numpy(index_io.read_array(index_dir, "ivf_list_size", mmap=False))
    return _place(arrays, mesh, axis_name, meta, centroids, list_size)


def _shard_norms(sharded: dict[str, Any]) -> torch.Tensor:
    """Squared row norms of the shard (l2), from the plan or its rows."""
    if "norms" not in sharded:
        vf = sharded["vecs"].float()
        sharded["norms"] = torch.sum(vf * vf, dim=-1)
    return sharded["norms"]


def _shard_rescore(sharded, xq, ids, rows, k, residual):
    """Shard-local exact re-rank: rebuild this shard's candidate rows in f32
    (``vecs * scales``, plus the list centroid on residual stores) and score
    them with the f32 queries.  As the reference's, with no int4
    refinement."""
    require_full_f32(xq)
    r = rows.long()
    sub = sharded["vecs"][r].float()
    if "scales" in sharded:
        sub = sub * sharded["scales"][r][..., None]
    if residual:
        sub = sub + sharded["centroids"][sharded["row_list"][r].long()]
    exact = torch.einsum("bd,bkd->bk", xq, sub)
    exact = torch.where(ids == NO_HIT, torch.full_like(exact, MASK_SCORE), exact)
    top_s, sel = torch.topk(exact, k, dim=1)
    return top_s, torch.gather(ids, 1, sel), torch.gather(rows, 1, sel)


def merge_shard_topk(mesh: ShardMesh, top_s: torch.Tensor, top_i: torch.Tensor, k: int, *, dedup: bool):
    """All-gather every rank's (B, k) candidates and merge them: a plain
    top-k, or (``dedup``: an id may come from two shards) a score-sorted
    top-2k whose duplicate ids keep their best copy."""
    n_dev, b = mesh.size, top_s.shape[0]
    cand_s = mesh.all_gather(top_s.float()).permute(1, 0, 2).reshape(b, n_dev * k)
    cand_i = mesh.all_gather(top_i.to(torch.int32)).permute(1, 0, 2).reshape(b, n_dev * k)
    if not dedup:
        merged_s, pos = torch.topk(cand_s, k, dim=1)
        return merged_s, torch.gather(cand_i, 1, pos)
    merged_s, pos = torch.topk(cand_s, min(2 * k, n_dev * k), dim=1)
    return dedup_topk(merged_s, torch.gather(cand_i, 1, pos), k)


def _finish(top_s, top_i, xq, metric, squeeze):
    dists = as_distance(top_s, metric)
    if metric == "l2":
        q_norms = torch.sum(xq * xq, dim=-1, keepdim=True)
        dists = torch.where(top_i == NO_HIT, torch.finfo(torch.float32).max, dists + q_norms)
    if squeeze:
        return dists[0], top_i[0]
    return dists, top_i


def _query_block(sharded, xq):
    squeeze = xq.ndim == 1
    if squeeze:
        xq = xq[None, :]
    return xq.to(device=sharded["vecs"].device, dtype=torch.float32), squeeze


def local_grouped_probe(
    sharded: dict[str, Any],
    xq: torch.Tensor,
    k: int,
    *,
    nprobe: int,
    metric: str,
    int8_queries: bool = False,
    rescore: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """This rank's part of ``sharded_ivf_search_pallas`` for (B, d) f32
    queries on its device: the coarse ranking over all centroids, K1 over
    the lists it owns, and the shard-local exact rescore.  Returns its (B, k)
    scores, ids and storage rows, before the merge."""
    meta = sharded["meta"]
    bl = int(meta["block_align"])
    max_blocks = max(1, int(meta["probe_window"]) // bl)
    vecs = sharded["vecs"]
    residual = meta.get("encoding") == "residual_int8" and vecs.dtype == torch.int8
    do_rescore = rescore is not None and metric != "l2" and "row_list" in sharded
    k_probe = max(k, rescore) if do_rescore else k
    spilled = float(meta.get("spill_frac", 0.0) or 0.0) > 0.0

    coarse_s, probe_lists = flat_search(sharded["centroids"], xq, nprobe, metric=metric)
    top_s, top_i, rows = _grouped_probe(
        sharded["centroids"], vecs, sharded["row_ids"], sharded["list_start"], sharded["list_size"],
        xq, sharded.get("scales"), _shard_norms(sharded) if metric == "l2" else None,
        k_probe, nprobe, max_blocks, metric, int8_queries,
        owned=sharded["owned"], probe_lists=probe_lists,
        probe_bias=coarse_s if residual else None, return_rows=True,
        packed_ok=do_rescore, bl=bl, spilled=spilled,
    )
    if do_rescore:
        return _shard_rescore(sharded, xq, top_i, rows, k, residual)
    return top_s, top_i, rows


def sharded_ivf_search_pallas(
    sharded: dict[str, Any],
    xq: torch.Tensor,
    k: int,
    *,
    nprobe: int,
    metric: str,
    int8_queries: bool = False,
    query_chunk: int | None = None,
    rescore: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Large-batch sharded IVF search: the grouped probe (K1) per rank.

    Each rank runs K1 over the lists it owns (pairs of other lists get no
    blocks), then the per-rank top-k candidates are all-gathered and every
    rank merges them identically.  ``rescore`` (ip/cosine) widens each
    rank's probe and exactly re-ranks its own top-``rescore`` candidates
    before the all-gather (the rows are rebuilt from the shard's storage,
    with no int4 refinement).  ``int8_queries`` / ``query_chunk`` are the
    single-device knobs.  Returns replicated (distances, ids).
    """
    meta = sharded["meta"]
    bl = int(meta.get("block_align", 0))
    if bl < 512 or bl % NBK != 0:
        raise ValueError(f"sharded grouped probe requires a block_align >= 512 build; got {bl}")
    nprobe = max(1, min(nprobe, int(meta["nlist"])))
    xq, squeeze = _query_block(sharded, xq)

    if query_chunk is not None and xq.shape[0] > query_chunk:
        parts = [
            sharded_ivf_search_pallas(
                sharded, xq[lo : lo + query_chunk], k, nprobe=nprobe, metric=metric,
                int8_queries=int8_queries, rescore=rescore,
            )
            for lo in range(0, xq.shape[0], query_chunk)
        ]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    top_s, top_i, _ = local_grouped_probe(
        sharded, xq, k, nprobe=nprobe, metric=metric, int8_queries=int8_queries, rescore=rescore,
    )
    # Unspilled stores hold each row in one list, hence one shard: a plain
    # k-way merge.  Spilled rows can come from two shards.
    spilled = float(meta.get("spill_frac", 0.0) or 0.0) > 0.0
    top_s, top_i = merge_shard_topk(sharded["mesh"], top_s, top_i, k, dedup=spilled)
    return _finish(top_s, top_i, xq, metric, squeeze)


def sharded_ivf_search(
    sharded: dict[str, Any],
    xq: torch.Tensor,
    k: int,
    *,
    nprobe: int,
    metric: str,
    rescore: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sharded window probe; returns replicated (distances, ids).

    Each rank runs the window probe over the lists it owns, in the steps
    ``plan_window_probe`` cuts under the single-device probe's default
    gather budget (the reference gathers B x nprobe x window rows at once;
    the top-k of the steps' union is the same).  ``rescore`` (ip/cosine) exactly re-ranks each rank's
    top-``rescore`` candidates before the all-gather.  The merge always
    drops duplicate ids.
    """
    meta = sharded["meta"]
    window = int(meta["probe_window"])
    nprobe = max(1, min(nprobe, int(meta["nlist"])))
    xq, squeeze = _query_block(sharded, xq)
    vecs = sharded["vecs"]
    residual = meta.get("encoding") == "residual_int8" and vecs.dtype == torch.int8
    do_rescore = rescore is not None and metric != "l2" and "row_list" in sharded
    k_probe = max(k, rescore) if do_rescore else k
    query_chunk, slot_group, _ = plan_window_probe(
        xq.shape[0], nprobe, window, vecs.shape[1], vecs.dtype, DEFAULT_GATHER_BUDGET_BYTES
    )
    top_s, top_i, rows = _ivf_probe(
        sharded["centroids"], vecs, sharded["row_ids"], sharded["list_start"], sharded["list_size"],
        xq, k_probe, nprobe, window, metric, query_chunk, slot_group,
        sharded.get("scales"), _shard_norms(sharded) if metric == "l2" else None,
        residual=residual, owned=sharded["owned"], return_rows=True,
    )
    if do_rescore:
        top_s, top_i, _ = _shard_rescore(sharded, xq, top_i, rows, k, residual)
    top_s, top_i = merge_shard_topk(sharded["mesh"], top_s, top_i, k, dedup=True)
    return _finish(top_s, top_i, xq, metric, squeeze)
