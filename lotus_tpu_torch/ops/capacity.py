"""Device memory of a served IVF store: bytes per row of each encoding, the
transients of the serving paths, and the most rows a card holds beside them.

A store's state (``load_ivf_state``, ``synth_ivf_device_build``) holds, once
it has served a search:

- per storage slot (each stored copy, list padding and the dead window
  tail): the row in its dtype, its row id (int32), the int8 row scale (int8
  stores), the slot's list id (residual stores: ``ensure_pos_list``, read by
  rescoring) and the squared norm (l2);
- per original row: ``ivf_inv_perm`` (int32) and, when refined, the packed
  int4 refinement (d / 2 bytes) and its f32 scale.  A spill copy costs one
  slot and nothing per row: it has no refinement entry;
- per list: the f32 centroid, its start and size (int32).

``state_bytes`` is the sum; a CPU test holds it to the ``nbytes`` of a built
state.
"""

from __future__ import annotations

import torch

_ESIZE = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2, torch.int8: 1}


def slot_bytes(d: int, dtype: torch.dtype, *, residual: bool = False, l2: bool = False) -> int:
    """Bytes of one storage slot."""
    return d * _ESIZE[dtype] + 4 + (4 if dtype == torch.int8 else 0) + (4 if residual else 0) + (4 if l2 else 0)


def row_bytes(d: int, *, refine: bool = False) -> int:
    """Bytes of one original row beyond its slots."""
    return 4 + (d // 2 + 4 if refine else 0)


def state_bytes(n: int, slots: int, nlist: int, d: int, dtype: torch.dtype, *, residual: bool = False,
                refine: bool = False, l2: bool = False) -> int:
    """Bytes of a serving store of ``n`` rows in ``slots`` storage slots."""
    return (slots * slot_bytes(d, dtype, residual=residual, l2=l2) + n * row_bytes(d, refine=refine)
            + nlist * (4 * d + 8))


def k1_pool_bytes(query_chunk: int, nprobe: int, nlist: int, *, top1: bool = False, packed: bool = True) -> int:
    """Transient bytes of one grouped-probe slice: K1's output over the
    static grid (``P / 128 + nlist + 1`` chunks of 128 slots, ``P`` =
    query_chunk * nprobe pairs), f32 scores and, when not ``packed``, their
    int32 storage rows.  K3 (``pool_select``) reads it in place; its
    (query_chunk, k_out) head is small beside it."""
    from lotus_tpu_torch.ops.ivf_probe import QU, ncand

    p = query_chunk * nprobe
    planes = 1 if packed else 2
    return (p // QU + nlist + 1) * QU * ncand(top1) * 4 * planes


def subset_bytes(n_ids: int, d: int, dtype: torch.dtype, *, residual: bool = False) -> int:
    """Transient bytes of ``TorchVS._ivf_subset_search`` over ``n_ids`` rows:
    the gathered rows, and on residual int8 stores their f32 reconstruction
    (the cast, the scaled rows and the gathered centroids)."""
    return n_ids * d * (_ESIZE[dtype] + (12 if residual else 0))


def max_rows(free_bytes: int, d: int, dtype: torch.dtype, *, nlist: int, block_align: int, window: int,
             residual: bool = False, refine: bool = False, l2: bool = False, spill_frac: float = 0.0) -> int:
    """The most rows a store holds in ``free_bytes`` (the card's memory less
    the transients it must leave room for): each row takes ``1 + spill_frac``
    slots, the lists pad half a block each on average, and the window tail
    adds ``window`` slots."""
    slot = slot_bytes(d, dtype, residual=residual, l2=l2)
    fixed = (nlist * block_align // 2 + window) * slot + nlist * (4 * d + 8)
    per_row = (1 + spill_frac) * slot + row_bytes(d, refine=refine)
    return max(0, int((free_bytes - fixed) // per_row))
