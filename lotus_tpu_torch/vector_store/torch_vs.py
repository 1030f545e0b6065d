"""TorchVS — the device-resident vector store of the port.

Counterpart of ``lotus_tpu/vector_store/tpu_vs.py``.  Vectors live in device
memory; the planner (``tpu_vs.py:699-817``) routes

- an IVF store without ``ids`` to the grouped probe (``ops/ivf_probe.py``,
  kernel K1) when the store is block-aligned and calibration has not dropped
  that regime; otherwise to the window probe (``ops/ivf.py::ivf_search``)
  when B * nprobe < nlist, and to the exhaustive flat scan when not;
- an IVF store with ``ids`` to an exact scan of just the allowed rows
  (``_ivf_subset_search``) — the path the pandas operators take, since
  ``sem_search`` and ``sem_sim_join`` always pass ``ids``;
- a Flat store without ``ids`` to the streaming scan (``ops/flat_scan.py``,
  kernel K2) where ``TpuVS`` takes it (``tpu_vs.py:781-791``): ``scan="pallas"``,
  or ``"auto"`` with ``approx``, bf16 storage and B >= 256, on ip/cosine
  stores whose padded length is whole 1024-row blocks;
- any other Flat search to ``flat_search`` with a validity mask.
  int8 Flat stores rescore exactly in f32 (32 candidates by default).

With ``recall_target`` an IVF store calibrates ``nprobe`` on first use
(``calibrate_nprobe``, ``ops/autotune.py``) or adopts a calibration persisted
in ``meta.json`` by either package.  ``stats["routes"]`` counts the searches
each route served.

Each call is the span ``vs.call`` (``lotus_tpu_torch.profiling``) over
``vs.inputs`` (the queries, and an ids search's ids, to the device), the
route's spans (``ivf.subset_rows`` and ``ivf.subset_scan`` for an ids
search, ``ivf.search`` for the grouped probe, ``vs.scan`` otherwise),
``vs.wait`` (the answers' copies to the host, which wait for the device)
and ``vs.to_lists``.

With a ``mesh`` of several ranks (``lotus_tpu_torch.parallel``) the store is
sharded as ``TpuVS``'s is (``tpu_vs.py:200-256``): ``index()`` also persists
one IVF shard per rank, each rank loads only its own, and searches run the
sharded grouped probe, the sharded window probe or the sharded Flat scan,
whose candidates every rank all-gathers and merges.  Every rank makes the
same calls with the same queries.  An ids search on a shard-only state scans
the allowed rows of the on-disk f32 ``vectors`` exactly.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Optional

import numpy as np
import torch
from numpy.typing import NDArray

from lotus_tpu_torch.ops import io as index_io
from lotus_tpu_torch.ops.common import require_full_f32, round_up
from lotus_tpu_torch.ops.flat import DEFAULT_BLOCK_ROWS, flat_search
from lotus_tpu_torch.ops.ivf import default_device, ivf_search
from lotus_tpu_torch.profiling import annotate
from lotus_tpu_torch.types import RMOutput
from lotus_tpu_torch.vector_store.vs import VS

logger = logging.getLogger("lotus_tpu_torch")

_DTYPE_NAMES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int8": torch.int8,
}


class TorchVS(VS):
    """Flat / IVF-Flat vector store on one torch device, or sharded over the
    ranks of a ``mesh``.

    Takes ``TpuVS``'s constructor arguments plus ``device`` (default: the
    GPU when there is one).  ``mesh`` is a ``lotus_tpu_torch.parallel``
    ``ShardMesh``; the store then lives on the mesh's device and each rank
    holds its shard (``TorchVS.distributed()`` builds one over every rank).
    ``approx`` routes bf16 Flat searches of
    B >= 256 to K2 under ``scan="auto"``; ``flat_search`` itself serves it
    exactly (see ``ops/flat.py``).  ``recall_target``: see
    ``calibrate_nprobe``.
    """

    def __init__(
        self,
        index_type: str = "flat",
        metric: str = "ip",
        device_dtype: str = "float32",
        nlist: Optional[int] = None,
        nprobe: Optional[int] = None,
        mesh: Optional[Any] = None,
        approx: bool = False,
        block_rows: int = DEFAULT_BLOCK_ROWS,
        int8_encoding: str = "residual",
        spill_frac: float = 0.0,
        int8_refine: bool = False,
        rescore: Optional[int] = None,
        scan: str = "auto",
        int8_queries: Optional[bool] = None,
        query_chunk: int = 2048,
        recall_target: Optional[float] = None,
        device: torch.device | str | None = None,
    ) -> None:
        super().__init__()
        if index_type not in ("flat", "ivf"):
            raise ValueError(f"index_type must be 'flat' or 'ivf', got {index_type!r}")
        if int8_encoding not in ("residual", "plain"):
            raise ValueError(f"int8_encoding must be 'residual' or 'plain', got {int8_encoding!r}")
        if scan not in ("auto", "xla", "pallas"):
            raise ValueError(f"scan must be 'auto', 'xla' or 'pallas', got {scan!r}")
        self.mesh = mesh
        self.index_type = index_type
        self.metric = metric
        self.device_dtype = device_dtype
        self.nlist = nlist
        # None = "use the default (32) until calibration picks one"; an
        # explicit value is respected, and calibration warns before repinning it.
        self._nprobe_user_set = nprobe is not None
        # Serving regimes disabled by calibration (see _adopt_calibration).
        self._regimes_dropped: set[str] = set()
        self.nprobe = 32 if nprobe is None else int(nprobe)
        self.approx = approx
        self.block_rows = block_rows
        self.int8_encoding = int8_encoding
        self.spill_frac = spill_frac
        self.int8_refine = int8_refine
        self.rescore = rescore
        self.scan = scan
        # None = int8 queries exactly when the store is int8 and rescoring is on.
        self.int8_queries = int8_queries
        self.query_chunk = query_chunk
        self.recall_target = recall_target
        if mesh is not None:
            self.device = mesh.device
        else:
            self.device = torch.device(device) if device is not None else default_device()
        self.index_dir: str | None = None
        self._state: dict[str, Any] | None = None
        self.stats: dict[str, Any] = {
            "searches": 0,
            "queries": 0,
            "subset_searches": 0,
            # End-to-end wall time per search, device->host transfer included.
            "total_wall_s": 0.0,
            # Searches by the route that served them; IVF searches with ids
            # take the subset scan and count in subset_searches only.
            "routes": {"grouped_probe": 0, "window_probe": 0, "scan": 0},
        }

    def _mesh_devices(self) -> int:
        return self.mesh.size if self.mesh is not None else 1

    @classmethod
    def distributed(cls, **kwargs: Any) -> "TorchVS":
        """A store sharded over every rank (``tpu_vs.py:142-155``): starts the
        process group when the environment declares one (``init_runtime``),
        builds the host-ordered serving mesh, and returns a TorchVS over it."""
        from lotus_tpu_torch.parallel import init_runtime, serving_mesh

        init_runtime()
        return cls(mesh=serving_mesh(device=kwargs.pop("device", None)), **kwargs)

    # ------------------------------------------------------------------ build
    def index(self, docs: list[str], embeddings: NDArray[np.float64], index_dir: str, **kwargs: Any) -> None:
        emb = np.ascontiguousarray(np.asarray(embeddings, dtype=np.float32))
        if emb.ndim != 2:
            raise ValueError(f"embeddings must be 2-D, got shape {emb.shape}")
        # Under a mesh the reference writes the index from every process;
        # here rank 0 writes it with its shards, and every rank waits for it.
        if self.mesh is None or self.mesh.slot == 0:
            self._write_index(emb, index_dir)
        if self._mesh_devices() > 1:
            self.mesh.barrier()
        self.index_dir = index_dir
        self._state = None  # lazily materialized on first search

    def _write_index(self, emb: np.ndarray, index_dir: str) -> None:
        index_io.write_array(index_dir, "vectors", emb)
        meta: dict[str, Any] = {
            "kind": self.index_type,
            "metric": self.metric,
            "n_rows": int(emb.shape[0]),
            "dim": int(emb.shape[1]),
            "device_dtype": self.device_dtype,
        }
        if self.index_type == "ivf":
            from lotus_tpu_torch.ops.ivf import build_ivf
            from lotus_tpu_torch.ops.ivf_probe import BL

            nlist = self.nlist or max(1, int(np.sqrt(emb.shape[0])))
            # Block-align lists when the average list fills a block, so the
            # padding is cheap and the grouped probe applies.
            if emb.shape[0] >= BL * nlist:
                block_align = BL
            elif emb.shape[0] >= 512 * nlist:
                block_align = 512
            else:
                block_align = None
            meta.update(build_ivf(
                index_dir, emb, nlist=nlist, metric=self.metric, block_align=block_align,
                spill_frac=self.spill_frac if block_align else 0.0, device=self.device,
            ))
            if self.device_dtype == "int8" and self.int8_encoding == "residual" and self.metric != "l2":
                meta["encoding"] = "residual_int8"
        index_io.write_meta(index_dir, meta)
        if meta["kind"] == "ivf" and self._mesh_devices() > 1:
            # The config-5 lifecycle: one shard per mesh slot, so that at
            # serve time each rank reads only its own (and never quantizes).
            from lotus_tpu_torch.ops.ivf import load_ivf_state
            from lotus_tpu_torch.parallel import save_ivf_shards

            full = load_ivf_state(index_dir, meta, _DTYPE_NAMES[self.device_dtype], refine_int4=False, device="cpu")
            full["meta"] = full.get("meta", meta)
            save_ivf_shards(index_dir, full, self._mesh_devices())

    def load_index(self, index_dir: str) -> None:
        index_io.read_meta(index_dir)  # validate manifest
        self.index_dir = index_dir
        self._state = None

    # ------------------------------------------------------------- device load
    def _materialize(self) -> dict[str, Any]:
        if self._state is not None:
            return self._state
        if self.index_dir is None:
            raise ValueError("Index not loaded")
        meta = index_io.read_meta(self.index_dir)
        dtype = _DTYPE_NAMES[meta.get("device_dtype", self.device_dtype)]
        if os.path.exists(os.path.join(self.index_dir, "vectors.npy")):
            n, d = index_io.read_array(self.index_dir, "vectors").shape
        else:  # a directory save_ivf_state wrote keeps no f32 rows
            n, d = int(meta["n_rows"]), int(meta["dim"])
        state: dict[str, Any] = {"meta": meta, "n_rows": n, "dim": d, "dtype": dtype}
        if meta["kind"] == "ivf":
            from lotus_tpu_torch.ops.ivf import load_ivf_state

            if self._mesh_devices() > 1 and index_io.has_shard_manifest(self.index_dir):
                # Shard-persisted index: each rank loads only its own shard;
                # the monolithic arrays never reach the card.
                from lotus_tpu_torch.parallel import load_sharded_ivf_state

                sharded = load_sharded_ivf_state(self.index_dir, meta, self.mesh)
                state["meta"] = sharded["meta"]
                state["ivf_sharded"] = sharded
            else:
                state.update(
                    load_ivf_state(self.index_dir, meta, dtype, refine_int4=self.int8_refine, device=self.device)
                )
                if self._mesh_devices() > 1:
                    from lotus_tpu_torch.parallel import shard_ivf_state

                    # Keep the load's encoding decision (residual coding falls
                    # back to plain int8 when residuals are no smaller), or
                    # the shards would add a centroid bias to plain rows.
                    ivf_full = dict(state)
                    ivf_full["meta"] = state.get("meta") or meta
                    state["ivf_sharded"] = shard_ivf_state(ivf_full, self.mesh)
        else:
            self._ensure_flat_arrays(state)
        self._state = state
        return state

    def _ensure_flat_arrays(self, state: dict[str, Any]) -> None:
        """Materialize the scan arrays (flat indexes, and IVF stores that
        take the exhaustive scan).  ``flat_search`` scans a ragged last
        block, so unlike the reference the rows are not padded."""
        if "xb" in state:
            return
        meta, dtype = state["meta"], state["dtype"]
        vecs = index_io.read_array(self.index_dir, "vectors")
        xb_t = torch.from_numpy(np.array(vecs, dtype=np.float32)).to(self.device)
        if dtype == torch.int8:
            from lotus_tpu_torch.ops.quant import quantize_rows

            state["xb"], state["xb_scales"] = quantize_rows(xb_t)
            rows = xb_t  # l2 norms of the unquantized rows, as the reference keeps them
        else:
            state["xb"] = xb_t.to(dtype)
            state["xb_scales"] = None
            rows = state["xb"].float()
        state["xb_norms_sq"] = torch.sum(rows * rows, dim=-1) if meta["metric"] == "l2" else None
        if self._mesh_devices() > 1:
            from lotus_tpu_torch.parallel import shard_rows

            state["xb_sharded"], _ = shard_rows(state["xb"], self.mesh, block_rows=self.block_rows)
            if state["xb_scales"] is not None:
                state["xb_scales_sharded"], _ = shard_rows(state["xb_scales"], self.mesh, block_rows=self.block_rows)

    # ------------------------------------------------------- ids-subset (IVF)
    def _ids_tensor(self, ids: list[int]) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, dtype=np.int64), device=self.device)

    def _ivf_subset_search(
        self, state: dict[str, Any], xq: torch.Tensor, k: int, ids: list[int] | torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Exact search restricted to ``ids`` (a list, or int64 on the
        store's device): gather the allowed rows out of the IVF storage via
        the row-id -> storage-row inverse permutation and scan them exactly
        (O(|ids| x d), no second full-size copy).  The reference pads the
        subset to power-of-two sizes to bound XLA recompiles; eager torch
        needs no padding."""
        from lotus_tpu_torch.ops.ivf import ensure_inv_perm, ensure_pos_list

        meta = state["meta"]
        ids_t = ids if isinstance(ids, torch.Tensor) else self._ids_tensor(ids)
        m = ids_t.shape[0]

        with annotate("ivf.subset_rows"):
            storage_rows = ensure_inv_perm(state)[ids_t].long()
            subset = state["ivf_vectors"][storage_rows]
            scales = state.get("ivf_row_scales")
            sub_scales = scales[storage_rows] if scales is not None else None
            norms = state.get("ivf_norms_sq")
            sub_norms = norms[storage_rows] if norms is not None else None
            if meta.get("encoding") == "residual_int8" and subset.dtype == torch.int8:
                # Residual store: reconstruct f32 rows (residual * scale + centroid).
                lists_of_rows = ensure_pos_list(state)[storage_rows].long()
                subset = subset.float() * sub_scales[:, None] + state["centroids"][lists_of_rows]
                sub_scales = None

        with annotate("ivf.subset_scan"):
            dists, pos = flat_search(
                subset, xq, min(k, m), metric=meta["metric"], n_rows=m, xb_norms_sq=sub_norms,
                block_rows=self.block_rows, xb_scales=sub_scales,
            )
            hit_ids = torch.where(pos >= 0, ids_t[torch.clamp(pos, min=0).long()], -1)
        return dists, hit_ids

    def _disk_subset_search(
        self, state: dict[str, Any], xq: torch.Tensor, k: int, ids: list[int]
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Exact search restricted to ``ids`` on a shard-only state (the
        config-5 reload): the allowed rows are gathered from the on-disk f32
        ``vectors`` (O(|ids| x d), at full f32 fidelity) and scanned exactly
        on the store's device."""
        vecs = index_io.read_array(self.index_dir, "vectors")
        ids_np = np.asarray(ids, dtype=np.int64)
        m = ids_np.shape[0]
        sub = torch.from_numpy(np.ascontiguousarray(vecs[ids_np], dtype=np.float32)).to(self.device)
        dists, pos = flat_search(
            sub, xq, min(k, m), metric=state["meta"]["metric"], n_rows=m, block_rows=self.block_rows,
        )
        ids_t = torch.from_numpy(ids_np).to(self.device)
        hit_ids = torch.where(pos >= 0, ids_t[torch.clamp(pos, min=0).long()], -1)
        return dists, hit_ids

    # ----------------------------------------------------------------- search
    def __call__(
        self, query_vectors: NDArray[np.float64], K: int, ids: list[int] | None = None, **kwargs: Any
    ) -> RMOutput:
        with annotate("vs.call", ids=None if ids is None else len(ids)) as span:
            return self._search(query_vectors, K, ids, span, **kwargs)

    def _search(
        self, query_vectors: NDArray[np.float64], K: int, ids: list[int] | None, span: Any, **kwargs: Any
    ) -> RMOutput:
        t_start = time.perf_counter()
        state = self._materialize()
        meta = state["meta"]
        n, d = state["n_rows"], state["dim"]
        # Shard-only states (the config-5 reload) gather an ids search's rows from disk.
        subset = meta["kind"] == "ivf" and ids is not None and "ivf_vectors" in state

        with annotate("vs.inputs"):
            xq = np.asarray(query_vectors, dtype=np.float32)
            if xq.ndim == 1:
                xq = xq[None, :]
            if xq.shape[1] != d:
                raise ValueError(f"query dim {xq.shape[1]} != index dim {d}")
            xq_t = torch.from_numpy(np.ascontiguousarray(xq)).to(self.device)
            ids_t = self._ids_tensor(ids) if subset else None
        if span is not None:
            span.attrs["batch"] = int(xq.shape[0])
        k_eff = int(min(K, max(n, 1)))

        if meta["kind"] == "ivf" and ids is not None:
            if subset:
                dists, idx = self._ivf_subset_search(state, xq_t, k_eff, ids_t)
            else:
                with annotate("vs.scan"):
                    dists, idx = self._disk_subset_search(state, xq_t, k_eff, ids)
            return self._finish_output(dists, idx, xq, k_eff, K, ids, t_start)

        route = "scan"
        if meta["kind"] == "ivf":
            if self.recall_target is not None and "nprobe" not in kwargs:
                # Lazy autotune: the first search calibrates (or adopts the
                # entry persisted in meta.json) and pins self.nprobe, once, at
                # recall@10 — not per K, which would rerun the oracle for
                # every distinct K.  calibrate_nprobe(k=...) for another k.
                self.calibrate_nprobe(self.recall_target, k=min(10, max(n, 1)))
            nprobe = int(kwargs.get("nprobe", self.nprobe))
            if self._pallas_eligible(meta) and "pallas" not in self._regimes_dropped:
                route = "grouped_probe"
            elif xq.shape[0] * max(nprobe, 1) < int(meta.get("nlist", 1)):
                route = "window_probe"
            # Otherwise the exhaustive scan: one pass over the store serves
            # the whole batch.
        self.stats["routes"][route] += 1
        if route != "scan":
            dists, idx = self._probe_ivf(
                state, xq_t, k_eff, nprobe, use_pallas=route == "grouped_probe",
                rescore=kwargs.get("rescore", self.rescore),
                int8_queries=kwargs.get("int8_queries", self.int8_queries),
                query_chunk=kwargs.get("query_chunk", self.query_chunk),
            )
            return self._finish_output(dists, idx, xq, k_eff, K, ids, t_start)

        self._ensure_flat_arrays(state)
        with annotate("vs.scan"):
            dists, idx = self._flat_scan(state, xq_t, k_eff, ids, kwargs)
        return self._finish_output(dists, idx, xq, k_eff, K, ids, t_start)

    def _flat_scan(
        self, state: dict[str, Any], xq_t: torch.Tensor, k_eff: int, ids: list[int] | None,
        kwargs: dict[str, Any],
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The exhaustive scan route: the sharded scan, K2, or ``flat_search``
        with the ids as a row mask; int8 stores rescore exactly."""
        if "xb_sharded" in state:
            return self._sharded_scan(state, xq_t, k_eff, ids)
        meta, n = state["meta"], state["n_rows"]
        xb = state["xb"]
        valid = None
        if ids is not None:
            mask = np.zeros(xb.shape[0], dtype=bool)
            mask[np.asarray(ids, dtype=np.int64)] = True
            valid = torch.from_numpy(mask).to(self.device)
        # int8 flat scans rescore exactly in f32 by default.
        rescore = kwargs.get("rescore", self.rescore)
        if rescore is None and xb.dtype == torch.int8:
            rescore = 32
        do_rescore = rescore is not None and xb.dtype == torch.int8 and meta["metric"] in ("ip", "cosine")
        k_cand = max(k_eff, int(rescore)) if do_rescore else k_eff
        scan = kwargs.get("scan", self.scan)
        # The reference pads a store longer than one block to whole blocks
        # (tpu_vs.py:275) and gates K2 on that padded length; this store is
        # unpadded, so the gate reads the length the reference would have.
        n_pad = round_up(n, self.block_rows) if n > self.block_rows else n
        use_k2 = (
            valid is None and meta["metric"] in ("ip", "cosine") and n_pad % 1024 == 0
            and (scan == "pallas" or (
                scan == "auto" and self.approx and xq_t.shape[0] >= 256 and xb.dtype == torch.bfloat16
            ))
        )
        if use_k2:
            from lotus_tpu_torch.ops.flat_scan import flat_search_pallas

            dists, idx = flat_search_pallas(xb, xq_t, k_cand, n_rows=n, xb_scales=state.get("xb_scales"))
        else:
            dists, idx = flat_search(
                xb, xq_t, k_cand, metric=meta["metric"], n_rows=n, valid=valid,
                xb_norms_sq=state["xb_norms_sq"], block_rows=self.block_rows,
                xb_scales=state.get("xb_scales"),
            )
        if do_rescore:
            from lotus_tpu_torch.ops.flat import flat_rescore

            return flat_rescore(xb, xq_t, idx, k_eff, xb_scales=state.get("xb_scales"))
        return dists[:, :k_eff], idx[:, :k_eff]

    def _sharded_scan(
        self, state: dict[str, Any], xq_t: torch.Tensor, k_eff: int, ids: list[int] | None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The exhaustive scan of a row-sharded store (``tpu_vs.py:747-763``):
        ``sharded_flat_search`` with the ids as a row mask sharded like the
        rows.  As in the reference, it neither rescores nor takes K2."""
        from lotus_tpu_torch.parallel import shard_rows, sharded_flat_search

        valid = None
        if ids is not None:
            mask = np.zeros(state["xb_sharded"].shape[0] * self.mesh.size, dtype=bool)
            mask[np.asarray(ids, dtype=np.int64)] = True
            valid, _ = shard_rows(torch.from_numpy(mask), self.mesh, block_rows=self.block_rows)
        return sharded_flat_search(
            state["xb_sharded"], xq_t, k_eff, n_rows=state["n_rows"], metric=state["meta"]["metric"],
            mesh=self.mesh, valid=valid, block_rows=self.block_rows, approx=self.approx,
            xb_scales=state.get("xb_scales_sharded"),
        )

    def _probe_ivf(
        self,
        state: dict[str, Any],
        xq_t: torch.Tensor,
        k_eff: int,
        nprobe: int,
        *,
        use_pallas: bool,
        rescore: Optional[int],
        int8_queries: Optional[bool],
        query_chunk: Optional[int],
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One IVF probe on the serving path: the grouped probe (K1), with the
        int8-queries default of ``tpu_vs.py:420-440``, or the window probe;
        sharded when the state holds a shard."""
        metric = state["meta"]["metric"]
        sharded = state.get("ivf_sharded")
        if sharded is not None:
            from lotus_tpu_torch.parallel import sharded_ivf_search, sharded_ivf_search_pallas

            with annotate("vs.scan"):
                if not use_pallas:
                    return sharded_ivf_search(
                        sharded, xq_t, k_eff, nprobe=nprobe, metric=metric, rescore=rescore,
                    )
                if int8_queries is None:  # auto: int8 shards + rescoring active
                    int8_queries = bool(sharded["vecs"].dtype == torch.int8 and rescore)
                return sharded_ivf_search_pallas(
                    sharded, xq_t, k_eff, nprobe=nprobe, metric=metric, rescore=rescore,
                    int8_queries=int8_queries, query_chunk=query_chunk,
                )
        if use_pallas:
            from lotus_tpu_torch.ops.ivf_probe import ivf_search_grouped_probe

            if int8_queries is None:  # auto: int8 store + rescoring active
                int8_queries = bool(state["ivf_vectors"].dtype == torch.int8 and rescore)
            return ivf_search_grouped_probe(
                state, xq_t, k_eff, nprobe=nprobe, metric=metric, rescore=rescore,
                int8_queries=int8_queries, query_chunk=query_chunk,
            )
        with annotate("vs.scan"):
            return ivf_search(state, xq_t, k_eff, nprobe=nprobe, metric=metric, rescore=rescore)

    def _pallas_eligible(self, meta: dict[str, Any]) -> bool:
        """The grouped probe serves block-aligned stores: on the card through
        K1, on the CPU through K1's plain version.  (The reference also asks
        for a TPU or interpret mode, ``tpu_vs.py:461-464``.)"""
        return int(meta.get("block_align", 0)) >= 512

    def _exact_topk(self, xq: np.ndarray, k: int, metric: str) -> np.ndarray:
        """Exact float32 top-k over the unquantised on-disk corpus: the ground
        truth for absolute-recall calibration.  Streams ``vectors`` in row
        chunks to ``self.device`` and keeps a running top-k there, with TF32
        off (``tpu_vs.py:466-493`` keeps it on the host)."""
        vecs = index_io.read_array(self.index_dir, "vectors")
        n = vecs.shape[0]
        q = torch.from_numpy(np.ascontiguousarray(xq, dtype=np.float32)).to(self.device)
        require_full_f32(q)
        best_s = torch.empty((q.shape[0], 0), dtype=torch.float32, device=self.device)
        best_i = torch.empty((q.shape[0], 0), dtype=torch.int64, device=self.device)
        chunk = 1 << 18
        for start in range(0, n, chunk):
            block = torch.from_numpy(np.array(vecs[start : start + chunk], dtype=np.float32)).to(self.device)
            scores = q @ block.T
            if metric == "l2":  # argmin ||x-q||^2 == argmax (2 q.x - ||x||^2)
                scores = 2.0 * scores - torch.sum(block * block, dim=-1)[None, :]
            ids = torch.arange(start, start + block.shape[0], device=self.device).expand(q.shape[0], -1)
            cat_s, cat_i = torch.cat([best_s, scores], 1), torch.cat([best_i, ids], 1)
            best_s, pos = torch.topk(cat_s, min(k, cat_s.shape[1]), dim=1)
            best_i = torch.gather(cat_i, 1, pos)
        return best_i.cpu().numpy()

    def calibrate_nprobe(
        self,
        recall_target: Optional[float] = None,
        *,
        k: int = 10,
        nq: int = 256,
        seed: int = 0,
        persist: bool = True,
        ladder: Optional[list[int]] = None,
        oracle: str = "full_probe",
    ) -> dict[str, Any]:
        """Calibrate nprobe for a recall@k target and adopt it
        (``tpu_vs.py:495-642``).

        Samples ``nq`` stored rows as stand-in queries and walks an nprobe
        ladder on the probe path ``__call__`` serves with: the grouped probe
        on block-aligned stores, the window probe otherwise.  The result is
        persisted into ``meta.json`` under ``calibration["<target>@<k>"]``
        (``.../exact`` for the exact oracle), the key ``TpuVS`` uses, so a
        store calibrated by either package is adopted by the other without
        measuring; ``self.nprobe`` is set to the chosen value.

        ``oracle="full_probe"`` measures recall relative to the store's own
        full probe; ``"exact"`` against an exact f32 scan of the unquantised
        corpus (``_exact_topk``), flagging ``target_unreachable`` when the
        full probe itself falls short.  When the grouped probe's ceiling is
        below the target but the window probe reaches it, the ``"pallas"``
        regime is dropped (``regimes_dropped``, persisted with the entry):
        ``__call__`` then routes small batches to the window probe and large
        ones to the exhaustive scan.
        """
        from lotus_tpu_torch.ops import autotune

        if oracle not in ("full_probe", "exact"):
            raise ValueError(f"oracle must be 'full_probe' or 'exact', got {oracle!r}")
        state = self._materialize()
        meta = state["meta"]
        if meta["kind"] != "ivf":
            raise ValueError("calibrate_nprobe requires an IVF index")
        target = self.recall_target if recall_target is None else float(recall_target)
        if target is None:
            raise ValueError("pass recall_target= (or construct TorchVS with one)")
        key = f"{target:g}@{int(k)}" + ("" if oracle == "full_probe" else "/exact")
        cal = dict(meta.get("calibration") or {})
        if key in cal:
            self._adopt_calibration(cal[key])
            return cal[key]

        n = state["n_rows"]
        rng = np.random.default_rng(seed)
        sample = np.sort(rng.choice(n, size=min(nq, n), replace=False))
        xq = np.asarray(self.get_vectors_from_index(self.index_dir, sample.tolist()), dtype=np.float32)
        use_pallas = self._pallas_eligible(meta)

        def probe_fn(use_pallas_path: bool, q_chunk: int | None):
            def search_fn(q: np.ndarray, kk: int, nprobe: int) -> np.ndarray:
                q_t = torch.from_numpy(np.ascontiguousarray(q, dtype=np.float32)).to(self.device)
                # The window probe runs 32 queries at a time, as the reference's.
                parts = [q_t] if q_chunk is None else torch.split(q_t, q_chunk)
                out = [
                    self._probe_ivf(
                        state, p, kk, nprobe, use_pallas=use_pallas_path, rescore=self.rescore,
                        int8_queries=self.int8_queries, query_chunk=self.query_chunk,
                    )[1]
                    for p in parts
                ]
                return torch.cat(out).cpu().numpy()

            return search_fn

        # Calibrate the path __call__ serves: a block-aligned store serves
        # every batch size through the grouped probe, any other store through
        # the window probe.  Taking the min over a never-served regime would
        # inflate nprobe.
        fns = {"pallas": probe_fn(True, None)} if use_pallas else {"window": probe_fn(False, 32)}
        oracle_idx = self._exact_topk(xq, k, meta["metric"]) if oracle == "exact" else None
        result = autotune.calibrate_nprobe(
            fns, xq, nlist=int(meta["nlist"]), recall_target=target, k=k, ladder=ladder,
            oracle_indices=oracle_idx, oracle_regime="pallas" if use_pallas else "window",
        )
        if result.get("target_unreachable") and use_pallas:
            # The grouped probe's ceiling (its per-(query, list) candidate
            # caps) misses the target; the window probe scans whole lists.
            # Drop the grouped regime and recalibrate on the window probe, but
            # only when that reaches the target.  Otherwise the grouped
            # result is kept as it is, without comparing the two ceilings:
            # the reference's rule (tpu_vs.py:607), mirrored on purpose.
            recal = autotune.calibrate_nprobe(
                {"window": probe_fn(False, 32)}, xq, nlist=int(meta["nlist"]), recall_target=target,
                k=k, ladder=ladder, oracle_indices=oracle_idx, oracle_regime="window",
            )
            if not recal.get("target_unreachable"):
                logger.warning(
                    "calibrate_nprobe: the pallas regime cannot reach recall_target=%.4g (ceiling %.4f); "
                    "dropping it from serving and recalibrating on the window probe.",
                    target, result["ceiling"],
                )
                recal["regimes_dropped"] = ["pallas"]
                result = recal
        if result.get("target_unreachable"):
            logger.warning(
                "calibrate_nprobe: recall_target=%.4g is UNREACHABLE on this store — the full probe's "
                "recall@%d ceiling on the worst serving regime (%s oracle) is %.4f. Serving the full "
                "probe; rebuild with higher-fidelity storage (rescore/int8_refine/float32) to reach it.",
                target, k, result["oracle"], result["ceiling"],
            )
        cal[key] = result
        meta["calibration"] = cal
        if persist and self.index_dir is not None:
            # Persist onto the on-disk manifest (not the runtime meta, which
            # load_ivf_state may have annotated), so reloads skip the run.
            # Every rank calibrates alike; rank 0 writes.
            if self.mesh is None or self.mesh.slot == 0:
                disk_meta = index_io.read_meta(self.index_dir)
                disk_meta["calibration"] = {**(disk_meta.get("calibration") or {}), key: result}
                index_io.write_meta(self.index_dir, disk_meta)
            if self._mesh_devices() > 1:
                self.mesh.barrier()
        self._adopt_calibration(result)
        return result

    def _adopt_calibration(self, result: dict[str, Any]) -> None:
        # Regimes dropped by calibration persist with the entry, so reloads
        # route the same way without measuring again.
        self._regimes_dropped = set(result.get("regimes_dropped", []))
        new = int(result["nprobe"])
        if self._nprobe_user_set and new != self.nprobe:
            logger.warning(
                "calibrate_nprobe: overriding explicitly constructed nprobe=%d with calibrated "
                "nprobe=%d (recall_target=%g). Drop the nprobe= argument to silence this.",
                self.nprobe, new, result["recall_target"],
            )
        self.nprobe = new

    def _finish_output(
        self, dists: torch.Tensor, idx: torch.Tensor, xq: np.ndarray, k_eff: int, K: int,
        ids: list[int] | None, t_start: float,
    ) -> RMOutput:
        # Moving to the host waits for the device, so the wall-time stat
        # covers the whole search including the transfer.
        with annotate("vs.wait"):
            dists_h, idx_h = dists.cpu(), idx.cpu()
        with annotate("vs.to_lists"):
            dists_np = dists_h.numpy().astype(np.float64)
            idx_np = idx_h.numpy().astype(np.int64)
            self.stats["searches"] += 1
            self.stats["queries"] += int(xq.shape[0])
            if ids is not None:
                self.stats["subset_searches"] += 1
            self.stats["total_wall_s"] += time.perf_counter() - t_start
            if k_eff < K:  # faiss-style -1 padding when K exceeds the collection
                pad = K - k_eff
                dists_np = np.pad(dists_np, ((0, 0), (0, pad)), constant_values=0.0)
                idx_np = np.pad(idx_np, ((0, 0), (0, pad)), constant_values=-1)
            return RMOutput(distances=dists_np.tolist(), indices=idx_np.tolist())

    # ------------------------------------------------------------------- misc
    def get_vectors_from_index(self, index_dir: str, ids: list[int]) -> NDArray[np.float64]:
        vecs = index_io.read_array(index_dir, "vectors")
        return np.asarray(vecs[np.asarray(ids, dtype=np.int64)])
