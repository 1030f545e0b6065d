"""``lotus_tpu_torch.ops.ivf.ivf_search`` (the window probe) against
``lotus_tpu.ops.ivf.ivf_search`` on the same index directories.

Tolerance: the int8 and bf16 stores score bf16 operands with f32 sums in both
packages, and the f32 stores f32 throughout, but the sums run in another
order.  So the top-k sets must be equal except for a query whose reference
k-th and (k+1)-th scores lie within ``TOL`` (1e-4, on unit-norm rows), and
the scores of the ids both return within ``TOL``.  After exact rescoring the
sets must be equal.  Budgets that cut a batch into query chunks and slot
groups return the unchunked run's ids.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lotus_tpu.ops import ivf as jivf
from lotus_tpu_torch.ops import ivf as tivf
from lotus_tpu_torch.ops.ivf_probe import ivf_search_grouped_probe

TOL = 1e-4
_JT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8}


def _corpus(seed, n=3000, d=48, c=12, spread=0.25, nq=16):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((c, d)).astype(np.float32)
    emb = centers[rng.integers(0, c, n)] + spread * rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = emb[rng.integers(0, n, nq)] + 0.05 * rng.standard_normal((nq, d)).astype(np.float32)
    return emb, q / np.linalg.norm(q, axis=1, keepdims=True)


def _states(tmp_path, emb, *, nlist, metric="ip", dtype=torch.float32, encoding=None, refine=False, **build):
    idx = str(tmp_path / "idx")
    meta = {"kind": "ivf", "metric": metric, **jivf.build_ivf(idx, emb, nlist=nlist, metric=metric, **build)}
    if encoding:
        meta["encoding"] = encoding
    js = jivf.load_ivf_state(idx, meta, _JT[dtype], refine_int4=refine)
    js.setdefault("meta", meta)
    ts = tivf.load_ivf_state(idx, meta, dtype, refine_int4=refine, device="cpu")
    ts.setdefault("meta", meta)
    assert ts["meta"].get("encoding") == js["meta"].get("encoding")
    return js, ts


def _search_both(js, ts, q, k, **kw):
    rd, ri = jivf.ivf_search(js, jnp.asarray(q), k, **kw)
    pd, pi = tivf.ivf_search(ts, torch.from_numpy(q), k, **kw)
    return (np.asarray(rd), np.asarray(ri)), (pd.numpy(), pi.numpy())


def _assert_match(js, ts, q, k, *, exact_sets=False, **kw):
    (rd, ri), (pd, pi) = _search_both(js, ts, q, k, **kw)
    assert pi.dtype == np.int32 and pi.shape == ri.shape == (len(q), k)
    near = np.zeros(len(q), bool)
    if not exact_sets:
        rd1, _ = jivf.ivf_search(js, jnp.asarray(q), k + 1, **kw)
        s = np.abs(np.asarray(rd1))  # ordered either way; only the gap matters
        near = np.abs(s[:, k - 1] - s[:, k]) <= TOL
    for r in range(len(q)):
        if not near[r]:
            assert set(pi[r]) == set(ri[r]), (r, pi[r], ri[r])
        common = sorted(set(pi[r]) & set(ri[r]) - {-1})
        got = {i: d for i, d in zip(pi[r], pd[r])}
        want = {i: d for i, d in zip(ri[r], rd[r])}
        np.testing.assert_allclose([got[i] for i in common], [want[i] for i in common], rtol=TOL, atol=TOL)
    return pi


@pytest.mark.parametrize(
    "metric,dtype,encoding,refine,rescore",
    [
        ("ip", torch.float32, None, False, None),
        ("ip", torch.bfloat16, None, False, None),
        ("ip", torch.int8, None, False, None),  # plain int8
        ("ip", torch.int8, "residual_int8", False, None),
        ("ip", torch.int8, "residual_int8", False, 24),
        ("ip", torch.int8, "residual_int8", True, 24),  # + int4 refinement
        ("cosine", torch.int8, None, True, 24),
        ("l2", torch.float32, None, False, None),
        ("l2", torch.int8, None, False, None),  # load-time norms of the int8 rows
    ],
)
def test_window_probe_matches_reference(tmp_path, metric, dtype, encoding, refine, rescore):
    emb, q = _corpus(0)
    js, ts = _states(tmp_path, emb, nlist=24, metric=metric, dtype=dtype, encoding=encoding, refine=refine)
    assert int(js["meta"]["block_align"]) == 0  # 3000 rows in 24 lists: not block-aligned
    if encoding:
        assert ts["meta"]["encoding"] == "residual_int8"  # residual coding engaged
    for nprobe in (3, 24):
        _assert_match(js, ts, q, 10, exact_sets=rescore is not None, nprobe=nprobe, metric=metric,
                      rescore=rescore)


def test_spilled_block_aligned_store_dedups(tmp_path):
    """Spilled rows reach the pool through two lists: each id comes back once."""
    emb, q = _corpus(1, n=6144, d=32, c=16)
    js, ts = _states(tmp_path, emb, nlist=8, dtype=torch.int8, encoding="residual_int8", block_align=512,
                     spill_frac=0.2)
    rid = ts["ivf_row_ids"].numpy()
    assert np.bincount(rid[rid >= 0]).max() == 2
    for rescore in (None, 24):
        pi = _assert_match(js, ts, q, 10, exact_sets=rescore is not None, nprobe=3, metric="ip",
                           rescore=rescore)
        assert all(len(set(row)) == len(row) for row in pi.tolist())


def test_spilled_rows_map_to_their_last_copy(tmp_path):
    """``ensure_inv_perm`` maps a spilled row to its last storage copy, as the
    reference's numpy assignment does; the int4 refinement encodes that copy.
    (The port's index assignment used to leave the choice to the backend, and
    rescored scores of spilled rows differed by up to 2e-3.)"""
    emb, _ = _corpus(1, n=6144, d=32, c=16)
    js, ts = _states(tmp_path, emb, nlist=8, dtype=torch.int8, encoding="residual_int8", refine=True,
                     block_align=512, spill_frac=0.2)
    np.testing.assert_array_equal(tivf.ensure_inv_perm(ts).numpy(), np.asarray(jivf.ensure_inv_perm(js)))


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_k_past_the_probed_lists(tmp_path, metric):
    """K past what the probed lists hold: -1 ids, MASK_SCORE (ip) or the f32
    max (l2) distances, as the reference pads them."""
    emb, q = _corpus(2, n=600, d=16, c=8)
    js, ts = _states(tmp_path, emb, nlist=16, metric=metric)
    (rd, ri), (pd, pi) = _search_both(js, ts, q[:4], 400, nprobe=1, metric=metric)
    for r in range(4):
        assert set(pi[r]) == set(ri[r])
        assert (pi[r] == -1).sum() == (ri[r] == -1).sum() > 0
    np.testing.assert_array_equal(pd[pi == -1], rd[ri == -1])


def test_plan_window_probe():
    row = tivf.window_row_bytes(64, torch.int8)
    assert row == 64 + 4 * 64 + 17
    assert tivf.window_row_bytes(64, torch.float32) == 4 * 64 + 17
    per_query = 8 * 100 * row
    assert tivf.plan_window_probe(50, 8, 100, 64, torch.int8, 10 * per_query) == (10, 8, 10 * per_query)
    assert tivf.plan_window_probe(3, 8, 100, 64, torch.int8, 10 * per_query)[0] == 3
    assert tivf.plan_window_probe(50, 8, 100, 64, torch.int8, per_query - 1) == (1, 7, 7 * 100 * row)
    with pytest.raises(ValueError, match="cannot hold one probe slot"):
        tivf.plan_window_probe(1, 8, 100, 64, torch.int8, 100 * row - 1)


@pytest.mark.parametrize("dtype,encoding", [(torch.float32, None), (torch.int8, "residual_int8")])
def test_budget_chunks_return_the_unchunked_ids(tmp_path, dtype, encoding):
    """Budgets that force several query chunks, and several slot groups of
    one query, return the ids (and scores) of the unchunked run."""
    emb, q = _corpus(3)
    _, ts = _states(tmp_path, emb, nlist=24, dtype=dtype, encoding=encoding)
    window, d, nprobe = int(ts["meta"]["probe_window"]), emb.shape[1], 12
    per_slot = window * tivf.window_row_bytes(d, dtype)
    xq = torch.from_numpy(q)
    kw = dict(nprobe=nprobe, metric="ip", rescore=24 if encoding else None)
    want_d, want_i = tivf.ivf_search(ts, xq, 10, **kw)
    assert tivf.plan_window_probe(len(q), nprobe, window, d, dtype, tivf.DEFAULT_GATHER_BUDGET_BYTES)[:2] == (
        len(q), nprobe)
    for budget, plan in ((3 * nprobe * per_slot, (3, nprobe)), (5 * per_slot, (1, 5)), (per_slot, (1, 1))):
        assert tivf.plan_window_probe(len(q), nprobe, window, d, dtype, budget)[:2] == plan
        got_d, got_i = tivf.ivf_search(ts, xq, 10, gather_budget_bytes=budget, **kw)
        torch.testing.assert_close(got_i, want_i, rtol=0, atol=0)
        torch.testing.assert_close(got_d, want_d, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="gather_budget_bytes"):
        tivf.ivf_search(ts, xq, 10, gather_budget_bytes=per_slot - 1, **kw)


def test_grouped_probe_matches_window_probe(tmp_path):
    """Mirror of ``tests/test_vector_store.py::test_grouped_probe_matches_window_probe``
    with the port's grouped probe (K1's plain version here), which needs a
    block-aligned store: the same top-10 sets and scores at nprobe 4 and 16.
    (K1 keeps a top-2 per 64 lanes of a list, so a fourth true neighbour in
    one lane could differ; these queries have none.)"""
    emb, q = _corpus(4, n=8192, d=64, c=16, nq=8)
    _, ts = _states(tmp_path, emb, nlist=16, block_align=512)
    xq = torch.from_numpy(q)
    for nprobe in (4, 16):
        d_win, i_win = tivf.ivf_search(ts, xq, 10, nprobe=nprobe, metric="ip")
        d_grp, i_grp = ivf_search_grouped_probe(ts, xq, 10, nprobe=nprobe, metric="ip")
        for r in range(len(q)):
            assert set(i_grp[r].tolist()) == set(i_win[r].tolist()), (nprobe, r)
        np.testing.assert_allclose(np.sort(d_grp.numpy(), 1), np.sort(d_win.numpy(), 1), rtol=1e-4, atol=1e-4)


def test_grouped_probe_l2_matches_window_probe(tmp_path):
    """Mirror of ``tests/test_vector_store.py::test_grouped_probe_l2``."""
    rng = np.random.default_rng(11)
    emb = rng.standard_normal((6144, 24)).astype(np.float32)
    q = rng.standard_normal((6, 24)).astype(np.float32)
    _, ts = _states(tmp_path, emb, nlist=12, metric="l2", block_align=512)
    d_win, i_win = tivf.ivf_search(ts, torch.from_numpy(q), 5, nprobe=12, metric="l2")
    d_grp, i_grp = ivf_search_grouped_probe(ts, torch.from_numpy(q), 5, nprobe=12, metric="l2")
    for r in range(6):
        assert set(i_grp[r].tolist()) == set(i_win[r].tolist())
    np.testing.assert_allclose(np.sort(d_grp.numpy(), 1), np.sort(d_win.numpy(), 1), rtol=1e-3, atol=1e-3)
