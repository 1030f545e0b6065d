"""Synthetic inputs of the grouped probe's layout stage (K5, ``probe_layout``)
and a plain numpy build of its outputs, shared by the CPU tests
(``test_torch_probe_layout.py``) and the card's (``test_torch_kernels_cuda.py``).

``LAYOUT_CASES`` are the stage's edges: one query, a batch that is not a
multiple of 32, every list probed by every query, lists probed by more than
128 queries (several chunks), empty lists and lists zeroed as not owned
beside lists no query probes, more lists than one block's tile, and config
4's slice.  Imports torch and numpy only, so the card's tests run without JAX.
"""

from __future__ import annotations

import numpy as np
import torch

QU = 128
BL = 1024
# Bit-for-bit views of the cases' query types.
BITS = {torch.int8: torch.int8, torch.bfloat16: torch.int16, torch.float32: torch.int32}

# (case, b, nlist, nprobe, d, extra): ``probed`` draws the lists from the
# first ``probed`` only; ``empty`` lists hold no rows; ``unowned`` lists
# have their sizes zeroed as the sharded caller zeroes lists it does not own.
LAYOUT_CASES = [
    ("one_query", 1, 8, 3, 64, {}),
    ("b_77", 77, 64, 16, 770, {}),
    ("nprobe_is_nlist", 40, 8, 8, 64, {}),
    ("lists_past_128_queries", 600, 8, 4, 768, {}),
    ("empty_and_unowned", 256, 512, 32, 768, dict(probed=384, empty=40, unowned=40)),
    ("list_tiles", 700, 2500, 40, 64, {}),
    ("config4_slice", 2048, 4096, 208, 768, {}),
]


def synth_layout(seed, *, b, nlist, nprobe, d, dtype, device="cpu", probed=None, empty=0, unowned=0):
    """``(probe_lists, xq_store, list_size)`` as ``_grouped_probe`` hands
    them to ``probe_layout``: distinct lists per query (int32), queries of
    ``dtype`` (int8 over [-127, 127], else seeded normals), list sizes
    (int32; 0 for the empty and the unowned lists)."""
    rng = np.random.default_rng(seed)
    probed = nlist if probed is None else probed
    probe_lists = np.argsort(rng.random((b, probed)), axis=1)[:, :nprobe].astype(np.int32)
    sizes = rng.integers(1, 8192, nlist).astype(np.int32)
    sizes[rng.permutation(nlist)[:empty]] = 0
    owned = np.ones(nlist, bool)
    owned[rng.permutation(nlist)[:unowned]] = False
    list_size = torch.where(torch.from_numpy(owned), torch.from_numpy(sizes), 0).to(torch.int32)
    if dtype == torch.int8:
        xq = torch.from_numpy(rng.integers(-127, 128, (b, d)).astype(np.int8))
    else:
        xq = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(dtype)
    return tuple(t.to(device) for t in (torch.from_numpy(probe_lists), xq, list_size))


def numpy_layout(probe_lists, xq_store, list_size, bl=BL):
    """The stage's outputs built from their definition: each pair's rank is
    its place among its list's pairs in query order (a stable sort by list),
    lists take chunks of QU slots in list order, and each pair's query row
    sits in its slot (zeros elsewhere, dead chunks included).  Returns
    ``(xq_units, chunk_list, padpos, blocks)`` on the CPU."""
    lists = probe_lists.cpu().numpy()
    sizes = list_size.cpu().numpy().astype(np.int64)
    b, nprobe = lists.shape
    nlist = sizes.shape[0]
    flat = lists.reshape(-1).astype(np.int64)
    order = np.lexsort((np.repeat(np.arange(b), nprobe), flat))
    counts = np.bincount(flat, minlength=nlist)
    first = np.cumsum(counts) - counts
    rank = np.empty(b * nprobe, np.int64)
    rank[order] = np.arange(b * nprobe) - first[flat[order]]
    chunks = -(-counts // QU)
    base = np.cumsum(chunks) - chunks
    n_chunks_max = b * nprobe // QU + nlist
    chunk_list = np.full(n_chunks_max + 1, -1, np.int32)
    chunk_list[: chunks.sum()] = np.repeat(np.arange(nlist), chunks)
    padpos = base[flat] * QU + rank
    units = torch.zeros((n_chunks_max * QU, xq_store.shape[1]), dtype=xq_store.dtype)
    units[torch.from_numpy(padpos)] = xq_store.cpu().repeat_interleave(nprobe, dim=0)
    blocks = np.where(counts > 0, -(-sizes // bl), 0).astype(np.int32)
    return units, torch.from_numpy(chunk_list), torch.from_numpy(padpos), torch.from_numpy(blocks)


def assert_layout(got, want):
    """The chunk table, each pair's slot and the block counts equal, and
    every row of a live chunk equal bit for bit (rows of dead chunks are
    free: K1 never reads them)."""
    units, chunk_list, padpos, blocks = (t.cpu() for t in got)
    w_units, w_chunk_list, w_padpos, w_blocks = want
    assert chunk_list.dtype == torch.int32 and torch.equal(chunk_list, w_chunk_list)
    assert padpos.dtype == torch.int64 and torch.equal(padpos, w_padpos)
    assert blocks.dtype == torch.int32 and torch.equal(blocks, w_blocks)
    assert units.dtype == w_units.dtype and units.shape == w_units.shape
    live = torch.repeat_interleave(chunk_list[:-1] >= 0, QU)
    assert torch.equal(units[live].view(BITS[units.dtype]), w_units[live].view(BITS[units.dtype]))
