"""The spill build of ``lotus_tpu_torch.ops.bench_data`` against
``lotus_tpu.ops.bench_data``, and the capacity model over a built state.

The two packages draw their corpora from different generators, so the plan
is held to the reference's bit for bit given the same assignments and
margins (numpy arrays handed to both); the built stores are held to their
own exact f32 oracle, as ``tests/test_bench_data.py`` holds the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lotus_tpu.ops.bench_data import _plan_layout_device
from lotus_tpu.ops.common import NO_HIT
from lotus_tpu.ops.ivf import plan_block_aligned_layout
from lotus_tpu_torch.ops import capacity
from lotus_tpu_torch.ops.bench_data import plan_spill_layout, synth_ivf_device_build
from lotus_tpu_torch.ops.ivf import ensure_pos_list
from lotus_tpu_torch.ops.ivf_probe import ivf_search_grouped_probe, probe_fold_reference

CFG = dict(n=2**15, d=64, nlist=64, n_clusters=48, chunk=2**13, queries_b=256, gt_queries=256, k=10)
SPILL = 0.1


def _reference_plan(a1, a2, mg, spill_frac, nlist, block_align):
    """``lotus_tpu/ops/bench_data.py:284-327`` on numpy arrays."""
    n = a1.shape[0]
    if spill_frac > 0:
        tau = float(np.quantile(mg, spill_frac))
        spill_rows = np.where(mg <= tau)[0].astype(np.int64)
        entry_assign = np.concatenate([a1, a2[spill_rows]])
        row_of_entry = np.concatenate([np.arange(n, dtype=np.int64), spill_rows]).astype(np.int32)
        plan = plan_block_aligned_layout(entry_assign, nlist, block_align, row_of_entry)
        entry_dest = np.empty(entry_assign.shape[0], np.int64)
        entry_dest[plan["order"]] = plan["dest"]
        row_ids = np.concatenate([plan["row_ids"], np.full(plan["window"], NO_HIT, np.int32)])
        return (plan["list_start"], plan["list_size"], plan["window"], row_ids,
                entry_dest[:n], spill_rows, entry_dest[n:])
    list_size = np.bincount(a1, minlength=nlist).astype(np.int32)
    padded = np.maximum(((list_size + block_align - 1) // block_align) * block_align, block_align)
    list_start = np.zeros(nlist, np.int32)
    list_start[1:] = np.cumsum(padded)[:-1]
    window = max(block_align, int(((list_size.max() + block_align - 1) // block_align) * block_align))
    dest, row_ids = _plan_layout_device(jnp.asarray(a1), jnp.asarray(list_start), int(padded.sum()) + window, nlist)
    return (list_start, list_size, window, np.asarray(row_ids), np.asarray(dest),
            np.empty(0, np.int64), np.empty(0, np.int64))


@pytest.mark.parametrize("spill_frac,block_align", [(0.0, 512), (0.05, 1024), (0.1, 512), (0.3, 1024)])
def test_spill_plan_matches_reference(spill_frac, block_align):
    rng = np.random.default_rng(int(spill_frac * 100) + block_align)
    n, nlist = 20_000, 24
    a1 = rng.integers(0, nlist, n).astype(np.int32)
    a2 = ((a1 + rng.integers(1, nlist, n)) % nlist).astype(np.int32)
    mg = rng.exponential(0.05, n).astype(np.float32)
    mg[::97] = mg[1::97][: mg[::97].shape[0]]  # tied margins at the quantile's edge are kept alike
    want = _reference_plan(a1, a2, mg, spill_frac, nlist, block_align)
    got = plan_spill_layout(torch.from_numpy(a1), torch.from_numpy(a2), torch.from_numpy(mg),
                            spill_frac, nlist, block_align)
    np.testing.assert_array_equal(got["list_start"], want[0])
    np.testing.assert_array_equal(got["list_size"], want[1])
    assert got["window"] == want[2]
    for key, ref in zip(("row_ids", "primary_dest", "spill_rows", "spill_dest"), want[3:]):
        np.testing.assert_array_equal(got[key].numpy().astype(np.int64), np.asarray(ref, np.int64), err_msg=key)
    if spill_frac > 0:
        assert got["spill_rows"].shape[0] >= int(spill_frac * n)


@pytest.fixture(scope="module")
def builds():
    return {frac: synth_ivf_device_build(**CFG, spill_frac=frac, seed=0, device="cpu") for frac in (0.0, SPILL)}


def test_spilled_store_holds_each_row_once_or_twice(builds):
    b, n = builds[SPILL], CFG["n"]
    st = b["state"]
    rid = st["ivf_row_ids"].numpy()
    counts = np.bincount(rid[rid >= 0], minlength=n)
    assert counts.min() == 1 and counts.max() == 2
    assert (counts == 2).sum() == b["spilled"]
    assert abs(b["spilled"] - SPILL * n) <= 0.02 * n, b["spilled"]
    # ivf_inv_perm is the primary copy: it holds the row, in its top-1 list.
    inv = st["ivf_inv_perm"].long()
    assert (st["ivf_row_ids"][inv] == torch.arange(n, dtype=torch.int32)).all()
    assert (ensure_pos_list(st)[inv] == b["assign"]).all()
    assert st["meta"]["spill_frac"] == SPILL
    # An unspilled build holds every row once, at its single position.
    rid0 = builds[0.0]["state"]["ivf_row_ids"].numpy()
    assert np.array_equal(np.sort(rid0[rid0 >= 0]), np.arange(n)) and builds[0.0]["spilled"] == 0


@pytest.mark.parametrize("nprobe", [2, 16])
def test_spilled_grouped_probe_recall(builds, nprobe):
    """Through the grouped probe (K1's plain version) with rescoring: the
    spilled store reaches at least the unspilled store's recall against its
    own exact f32 oracle, and no query's top-k repeats an id."""
    recall = {}
    for frac, b in builds.items():
        _, ids = ivf_search_grouped_probe(b["state"], b["queries"], CFG["k"], nprobe=nprobe, metric="ip",
                                          rescore=24, int8_queries=True, query_chunk=128)
        got = ids.numpy()
        for row in got:
            live = row[row >= 0]
            assert len(set(live.tolist())) == live.shape[0], row
        gt = b["gt"]
        recall[frac] = np.mean([len(set(got[i]) & set(gt[i])) / CFG["k"] for i in range(gt.shape[0])])
    assert recall[SPILL] >= recall[0.0] and recall[SPILL] >= 0.9, recall


@pytest.mark.parametrize("frac", [0.0, SPILL])
def test_capacity_formula_sums_the_built_state(builds, frac):
    st = builds[frac]["state"]
    ensure_pos_list(st)  # a served residual store holds it (rescoring reads it)
    have = sum(t.nbytes for t in st.values() if isinstance(t, torch.Tensor))
    want = capacity.state_bytes(CFG["n"], st["ivf_vectors"].shape[0], CFG["nlist"], CFG["d"], torch.int8,
                                residual=True, refine=True)
    assert have == want, (have, want)
    # The slot count behind it: (1 + spill) copies, the lists' padding and the window.
    slots = st["ivf_vectors"].shape[0]
    assert slots == CFG["n"] + builds[frac]["spilled"] + int((st["ivf_row_ids"] < 0).sum())
    rows = capacity.max_rows(have, CFG["d"], torch.int8, nlist=CFG["nlist"], block_align=1024,
                             window=int(st["meta"]["probe_window"]), residual=True, refine=True, spill_frac=frac)
    assert 0.8 * CFG["n"] <= rows <= 1.2 * CFG["n"], rows


@pytest.mark.parametrize("rescore", [24, None], ids=["packed", "unpacked"])
def test_k1_pool_bytes_is_k1_output(builds, rescore):
    """The slice's transient in the capacity model is K1's output as the
    grouped probe gets it: scores, and storage rows when not packed."""
    b = builds[0.0]
    seen = []

    def fold(*args, **kw):
        out = probe_fold_reference(*args, **kw)
        seen.append((kw["packed"], sum(t.nbytes for t in out if t is not None)))
        return out

    ivf_search_grouped_probe(b["state"], b["queries"], CFG["k"], nprobe=8, metric="ip", rescore=rescore,
                             int8_queries=True, query_chunk=128, fold=fold)
    assert [packed for packed, _ in seen] == [rescore is not None] * 2
    for packed, nbytes in seen:
        assert nbytes == capacity.k1_pool_bytes(128, 8, CFG["nlist"], packed=packed), (packed, nbytes)
