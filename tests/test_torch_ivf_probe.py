"""K1's plain PyTorch version (``lotus_tpu_torch.ops.ivf_probe``) held to the
Pallas probe (``lotus_tpu.ops.pallas_ivf._grouped_probe_pallas``, run with
``interpret=True``) on the same stores and the same ``probe_lists``.

Both sides take the probed lists from numpy, so the coarse ranking's rounding
stays out of the comparison, and ``k = nprobe * 128`` returns the whole
candidate pool, sorted.  The int8-query packed pool is integer arithmetic
followed by single f32 multiplies, so it must agree bit for bit; the float
variants sum in another order and agree within a tolerance.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import lotus_tpu.ops.pallas_ivf as pivf
from lotus_tpu.ops.ivf import build_ivf as jax_build_ivf
from lotus_tpu.ops.ivf import load_ivf_state as jax_load
from lotus_tpu_torch.ops import ivf_probe as tprobe
from lotus_tpu_torch.ops.ivf import load_ivf_state as torch_load
from torch_pool import assert_finish, assert_head, numpy_finish, numpy_pool, synth_pool

_JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8,
              torch.float16: jnp.float16}


def _corpus(rng, n, d, n_centers=8, spread=0.3):
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    emb = centers[rng.integers(0, n_centers, n)] + spread * rng.standard_normal((n, d)).astype(np.float32)
    return emb / np.linalg.norm(emb, axis=1, keepdims=True)


def _stores(tmp_path, emb, *, nlist, metric="ip", block_align=1024, dtype=torch.int8,
            encoding=None, spill_frac=0.0, name="s"):
    idx_dir = str(tmp_path / name)
    meta = {"kind": "ivf", "metric": metric,
            **jax_build_ivf(idx_dir, emb, nlist=nlist, metric=metric, block_align=block_align,
                            spill_frac=spill_frac)}
    if encoding:
        meta["encoding"] = encoding
    js = jax_load(idx_dir, meta, _JAX_DTYPE[dtype])
    js.setdefault("meta", meta)
    ts = torch_load(idx_dir, meta, dtype, device="cpu")
    ts.setdefault("meta", meta)
    return js, ts


def _exact_scale(xq):
    """Rows with max |x| = 127/128, so the int8 query scale is exactly 2**-7.

    Under ``jit`` XLA turns the reference's ``absmax / 127`` into a multiply
    by the reciprocal, which differs from the division (the port's, and the
    reference's outside ``jit``) in the last bit for some rows.  With this
    absmax both give 2**-7, so the bitwise tests see only the probe.
    """
    c = np.float32(0.9921875)
    out = np.clip(xq * (c / np.abs(xq).max(axis=1, keepdims=True)), -c, c).astype(np.float32)
    top = np.abs(out).argmax(axis=1)
    out[np.arange(len(out)), top] = np.copysign(c, out[np.arange(len(out)), top])
    return out


def _probe_lists(rng, b, nlist, nprobe):
    return np.argsort(rng.random((b, nlist)), axis=1)[:, :nprobe].astype(np.int32)


def _run_both(js, ts, xq, probe_lists, *, metric="ip", int8_queries=False, packed_ok=True,
              bias=None, k=None, owned=None, return_rows=False):
    meta = js["meta"]
    bl = int(meta["block_align"])
    nprobe = probe_lists.shape[1]
    max_blocks = max(1, int(meta["probe_window"]) // bl)
    spilled = float(meta.get("spill_frac", 0.0)) > 0
    k = nprobe * tprobe.NCAND if k is None else k
    l2 = metric == "l2"
    if l2 and "ivf_norms_sq" not in js:
        js["ivf_norms_sq"] = jnp.sum(jnp.square(js["ivf_vectors"].astype(jnp.float32)), axis=-1)
        vf = ts["ivf_vectors"].float()
        ts["ivf_norms_sq"] = torch.sum(vf * vf, dim=-1)
    j_out = pivf._grouped_probe_pallas(
        js["centroids"], js["ivf_vectors"], js["ivf_row_ids"], js["ivf_list_start"],
        js["ivf_list_size"], jnp.asarray(xq), js.get("ivf_row_scales"),
        js.get("ivf_norms_sq") if l2 else None, k, nprobe, max_blocks, metric, True, int8_queries,
        owned=None if owned is None else jnp.asarray(owned),
        probe_lists=jnp.asarray(probe_lists),
        probe_bias=None if bias is None else jnp.asarray(bias),
        return_rows=return_rows, packed_ok=packed_ok, bl=bl, spilled=spilled,
    )
    t_out = tprobe._grouped_probe(
        ts["centroids"], ts["ivf_vectors"], ts["ivf_row_ids"], ts["ivf_list_start"],
        ts["ivf_list_size"], torch.from_numpy(xq), ts.get("ivf_row_scales"),
        ts.get("ivf_norms_sq") if l2 else None, k, nprobe, max_blocks, metric, int8_queries,
        owned=None if owned is None else torch.from_numpy(owned),
        probe_lists=torch.from_numpy(probe_lists),
        probe_bias=None if bias is None else torch.from_numpy(bias),
        return_rows=return_rows, packed_ok=packed_ok, bl=bl, spilled=spilled,
    )
    return tuple(np.asarray(a) for a in j_out), tuple(t.numpy() for t in t_out)


def _assert_pool_bitwise(ref, got):
    """Same sorted scores bit for bit and the same multiset of (score, id).

    One deliberate divergence: a dot product of exactly 0 packs into a
    denormal that carries the row id.  XLA on the CPU flushes denormals in
    ``jnp.maximum``, so the reference decodes such a candidate as the first
    row of its list; the port keeps the id.  Zero-score entries are
    therefore held to equal counts, not equal ids.
    """
    (rs, ri), (gs, gi) = ref[:2], got[:2]
    np.testing.assert_array_equal(rs.view(np.int32), gs.view(np.int32))
    for q in range(rs.shape[0]):
        nz_r, nz_g = rs[q] != 0, gs[q] != 0
        assert sorted(zip(rs[q][nz_r].tolist(), ri[q][nz_r].tolist())) == sorted(
            zip(gs[q][nz_g].tolist(), gi[q][nz_g].tolist())
        ), q


def _assert_pool_close(ref, got, tol, k=10):
    (rs, ri), (gs, gi) = ref[:2], got[:2]
    live = rs > -1e38
    np.testing.assert_array_equal(live, gs > -1e38)
    np.testing.assert_allclose(gs[live], rs[live], rtol=tol, atol=tol)
    for q in range(rs.shape[0]):  # top-k sets agree where the boundary gap exceeds the tolerance
        if k >= rs.shape[1] or rs[q, k - 1] - rs[q, k] > 4 * tol:
            assert set(ri[q, :k].tolist()) == set(gi[q, :k].tolist()), q


def test_int8_query_packed_pool_bitwise(tmp_path):
    rng = np.random.default_rng(0)
    emb = _corpus(rng, 8192, 64)
    js, ts = _stores(tmp_path, emb, nlist=8)
    xq = _exact_scale(emb[:12] + 0.02 * rng.standard_normal((12, 64)).astype(np.float32))
    pl = _probe_lists(rng, 12, 8, 4)
    ref, got = _run_both(js, ts, xq, pl, int8_queries=True)
    assert (ref[0] > -1e38).sum() > 0
    _assert_pool_bitwise(ref, got)


@pytest.mark.parametrize("d", [66, 770])
def test_int8_query_packed_pool_bitwise_ragged_depth(tmp_path, d):
    """The int8 dot at d % 4 != 0, which K1 takes on the CUDA cores with a
    zero-padded last word: the pool equals the reference's bit for bit."""
    rng = np.random.default_rng(d)
    emb = _corpus(rng, 4096, d)
    js, ts = _stores(tmp_path, emb, nlist=4, block_align=512)
    xq = _exact_scale(emb[:6] + 0.02 * rng.standard_normal((6, d)).astype(np.float32))
    ref, got = _run_both(js, ts, xq, _probe_lists(rng, 6, 4, 2), int8_queries=True)
    assert (ref[0] > -1e38).sum() > 0
    _assert_pool_bitwise(ref, got)


_I8, _BF, _F32, _F16 = torch.int8, torch.bfloat16, torch.float32, torch.float16


@pytest.mark.parametrize(
    "qdt,xdt,d,int8_dot,l2,route",
    [
        (_F32, _F16, 768, False, False, "cuda-cores"),   # f16 store: f32 queries, as the reference keeps them
        (_F32, _F16, 770, False, True, "cuda-cores"),
        (_I8, _I8, 66, True, False, "cuda-cores"),       # the int8 dot at d % 4 != 0
        (_I8, _I8, 770, True, False, "cuda-cores"),
        (_I8, _I8, 768, True, False, "wgmma+tma"),
        (_BF, _I8, 768, False, False, "wgmma+tma+convert"),
        (_BF, _I8, 770, False, False, "cuda-cores"),
        (_BF, _BF, 768, False, True, "wgmma+tma"),
        (_F32, _F32, 768, False, False, "cuda-cores"),
    ],
)
def test_kernel_variant_accepts(qdt, xdt, d, int8_dot, l2, route):
    assert tprobe.kernel_variant(qdt, xdt, d, int8_dot=int8_dot, l2=l2) == route


@pytest.mark.parametrize(
    "qdt,xdt,int8_dot,l2",
    [
        (_I8, _I8, True, True),     # int8 queries with l2: the query scale is not rank-neutral
        (_I8, _I8, False, False),   # int8 queries without the int8 dot
        (_BF, _F16, False, False),  # the reference keeps f32 queries for f16 rows
        (_F16, _F16, False, False),
        (_F32, _I8, False, False),
        (_BF, _I8, True, False),
    ],
)
def test_kernel_variant_rejects_what_k1_lacks(qdt, xdt, int8_dot, l2):
    with pytest.raises(ValueError, match="probe_fold"):
        tprobe.kernel_variant(qdt, xdt, 64, int8_dot=int8_dot, l2=l2)


def test_int8_query_packed_residual_bias(tmp_path):
    rng = np.random.default_rng(1)
    emb = _corpus(rng, 8192, 32)
    js, ts = _stores(tmp_path, emb, nlist=8, block_align=512, encoding="residual_int8")
    assert js["meta"].get("encoding", "residual_int8") == ts["meta"].get("encoding", "residual_int8")
    xq = emb[:10] + 0.02 * rng.standard_normal((10, 32)).astype(np.float32)
    pl = _probe_lists(rng, 10, 8, 3)
    bias = rng.standard_normal((10, 3)).astype(np.float32)
    ref, got = _run_both(js, ts, xq, pl, int8_queries=True, bias=bias)
    _assert_pool_close(ref, got, 1e-6)


@pytest.mark.parametrize(
    "dtype,metric,packed_ok,tol",
    [
        (torch.bfloat16, "ip", True, 2e-2),     # bf16 store, packed
        (torch.int8, "ip", True, 2e-2),         # int8 store, bf16 queries (dequant)
        (torch.float32, "ip", False, 1e-5),     # f32, unpacked
        (torch.float32, "l2", False, 1e-4),     # f32 l2
        (torch.bfloat16, "l2", False, 2e-2),    # bf16 l2
        (torch.int8, "l2", False, 2e-2),        # l2 over int8 (bf16 queries)
        (torch.float16, "ip", False, 1e-5),     # f16 store, f32 queries
        (torch.float16, "l2", False, 1e-4),     # f16 l2
    ],
)
def test_float_variants_close(tmp_path, dtype, metric, packed_ok, tol):
    rng = np.random.default_rng(2)
    emb = _corpus(rng, 8192, 32)
    js, ts = _stores(tmp_path, emb, nlist=8, metric=metric, dtype=dtype)
    xq = emb[:8] + 0.02 * rng.standard_normal((8, 32)).astype(np.float32)
    pl = _probe_lists(rng, 8, 8, 4)
    ref, got = _run_both(js, ts, xq, pl, metric=metric, packed_ok=packed_ok)
    if packed_ok:  # truncated scores carry ids: compare values only
        ref, got = (ref[0], ref[0] * 0), (got[0], got[0] * 0)
        np.testing.assert_allclose(got[0], ref[0], rtol=tol, atol=tol)
    else:
        _assert_pool_close(ref, got, tol)


def test_unpacked_fallback_beyond_packed_id_range(tmp_path):
    rng = np.random.default_rng(3)
    emb = _corpus(rng, 18000, 32, n_centers=1, spread=0.2)
    js, ts = _stores(tmp_path, emb, nlist=2, block_align=512, encoding="residual_int8")
    assert int(js["meta"]["probe_window"]) > (1 << tprobe.LOCAL_BITS)
    xq = _exact_scale(emb[:4] + 0.01 * rng.standard_normal((4, 32)).astype(np.float32))
    pl = _probe_lists(rng, 4, 2, 2)
    ref, got = _run_both(js, ts, xq, pl, int8_queries=True, packed_ok=True)
    # int8 dot, unpacked: exact integer scores times one scale, ids are storage rows.
    _assert_pool_bitwise(ref, got)


def test_spilled_store_dedups(tmp_path):
    rng = np.random.default_rng(4)
    emb = _corpus(rng, 8192, 32)
    js, ts = _stores(tmp_path, emb, nlist=8, dtype=torch.float32, spill_frac=0.2)
    xq = emb[:6] + 0.01 * rng.standard_normal((6, 32)).astype(np.float32)
    pl = _probe_lists(rng, 6, 8, 8)
    ref, got = _run_both(js, ts, xq, pl, packed_ok=False, k=8)
    for row in got[1]:
        live = [v for v in row.tolist() if v >= 0]
        assert len(live) == len(set(live))
    _assert_pool_close(ref, got, 1e-5, k=8)


@pytest.mark.parametrize("align", [512, 1024])
def test_store_alignment(tmp_path, align):
    rng = np.random.default_rng(5)
    emb = _corpus(rng, 8192, 32)
    js, ts = _stores(tmp_path, emb, nlist=4, block_align=align)
    xq = _exact_scale(emb[:6] + 0.01 * rng.standard_normal((6, 32)).astype(np.float32))
    pl = _probe_lists(rng, 6, 4, 4)
    _assert_pool_bitwise(*_run_both(js, ts, xq, pl, int8_queries=True))


def test_lists_probed_by_more_than_one_chunk(tmp_path):
    rng = np.random.default_rng(6)
    emb = _corpus(rng, 8192, 32)
    js, ts = _stores(tmp_path, emb, nlist=8)
    xq = _exact_scale(emb[rng.integers(0, 8192, 512)])
    pl = _probe_lists(rng, 512, 8, 4)  # ~256 pairs per list -> 2+ chunks
    _assert_pool_bitwise(*_run_both(js, ts, xq, pl, int8_queries=True))


def test_single_query(tmp_path):
    rng = np.random.default_rng(7)
    emb = _corpus(rng, 8192, 32)
    js, ts = _stores(tmp_path, emb, nlist=8)
    pl = _probe_lists(rng, 1, 8, 3)
    _assert_pool_bitwise(*_run_both(js, ts, _exact_scale(emb[:1]), pl, int8_queries=True))


def test_argsort_grouping_matches_histogram(tmp_path, monkeypatch):
    rng = np.random.default_rng(8)
    emb = _corpus(rng, 8192, 32)
    _, ts = _stores(tmp_path, emb, nlist=8)
    xq = torch.from_numpy(emb[:40])
    pl = torch.from_numpy(_probe_lists(rng, 40, 8, 4))
    args = (ts["centroids"], ts["ivf_vectors"], ts["ivf_row_ids"], ts["ivf_list_start"],
            ts["ivf_list_size"], xq, ts["ivf_row_scales"], None, 64, 4, 2, "ip", True)
    hist_s, hist_i = tprobe._grouped_probe(*args, probe_lists=pl, packed_ok=True, bl=1024, spilled=False)
    monkeypatch.setattr(tprobe, "HIST_MAX_CELLS", 0)
    sort_s, sort_i = tprobe._grouped_probe(*args, probe_lists=pl, packed_ok=True, bl=1024, spilled=False)
    torch.testing.assert_close(sort_s, hist_s, rtol=0, atol=0)
    torch.testing.assert_close(sort_i, hist_i, rtol=0, atol=0)


@pytest.mark.parametrize(
    "dtype,int8_queries",
    [
        (torch.int8, True),       # residual int8 + refinement, int8-dot packed
        (torch.int8, False),      # the same store, bf16 queries (dequant)
        (torch.bfloat16, False),  # bf16 store, packed
    ],
)
def test_search_rescored_sets_match_reference(tmp_path, dtype, int8_queries):
    """End to end through both search entry points: the rescored top-k sets
    agree for each variant that packs candidates."""
    rng = np.random.default_rng(9)
    emb = _corpus(rng, 8192, 64)
    idx_dir = str(tmp_path / "e2e")
    meta = {"kind": "ivf", "metric": "ip", "encoding": "residual_int8",
            **jax_build_ivf(idx_dir, emb, nlist=8, metric="ip", block_align=1024)}
    js = jax_load(idx_dir, meta, _JAX_DTYPE[dtype], refine_int4=True)
    js.setdefault("meta", meta)
    ts = torch_load(idx_dir, meta, dtype, refine_int4=True, device="cpu")
    ts.setdefault("meta", meta)
    xq = emb[:16] + 0.02 * rng.standard_normal((16, 64)).astype(np.float32)
    jd, ji = pivf.ivf_search_pallas(js, jnp.asarray(xq), 10, nprobe=8, metric="ip", interpret=True,
                                    int8_queries=int8_queries, rescore=24)
    td, ti = tprobe.ivf_search_grouped_probe(ts, torch.from_numpy(xq), 10, nprobe=8, metric="ip",
                                             int8_queries=int8_queries, rescore=24, query_chunk=8)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    for q in range(16):
        assert set(ti[q].tolist()) == set(np.asarray(ji)[q].tolist()), q


@pytest.fixture
def top1_fold(monkeypatch):
    """Both packages under the top-1 fold.  The reference reads ``FOLD`` when
    it traces, so its jit cache is cleared before and after."""
    import jax

    jax.clear_caches()
    monkeypatch.setattr(pivf, "FOLD", "top1")
    monkeypatch.setattr(tprobe, "FOLD", "top1")
    yield
    jax.clear_caches()


@pytest.mark.parametrize(
    "dtype,metric,int8_queries,packed_ok",
    [
        (torch.int8, "ip", True, True),        # int8-dot packed: bit for bit
        (torch.int8, "ip", True, False),       # int8-dot unpacked: bit for bit, ids included
        (torch.float32, "l2", False, False),   # f32 l2 unpacked: within 1e-4, ids of clear lanes
    ],
)
def test_top1_fold_matches_reference(tmp_path, top1_fold, dtype, metric, int8_queries, packed_ok):
    rng = np.random.default_rng(10)
    emb = _corpus(rng, 8192, 32)
    js, ts = _stores(tmp_path, emb, nlist=8, metric=metric, dtype=dtype)
    xq = _exact_scale(emb[:24] + 0.02 * rng.standard_normal((24, 32)).astype(np.float32))
    pl = _probe_lists(rng, 24, 8, 4)
    ref, got = _run_both(js, ts, xq, pl, metric=metric, int8_queries=int8_queries, packed_ok=packed_ok,
                         k=4 * tprobe.NBK)
    assert (ref[0] > -1e38).sum() > 0
    if int8_queries:
        _assert_pool_bitwise(ref, got)
    else:
        _assert_pool_close(ref, got, 1e-4)


@pytest.mark.parametrize("packed", [True, False])
def test_top1_fold_is_the_top2_folds_best(packed):
    """The plain version's top-1 output is the best half of its top-2 output."""
    g = torch.Generator().manual_seed(4)
    bl, d = 512, 16
    sizes = torch.tensor([1500, 0, 512, 37], dtype=torch.int32)
    padded = torch.clamp((sizes + bl - 1) // bl, min=1) * bl
    starts = (torch.cumsum(padded, 0) - padded).to(torch.int32)
    x = torch.randint(-127, 128, (int(padded.sum()), d), generator=g, dtype=torch.int8)
    q = torch.randint(-127, 128, (5 * tprobe.QU, d), generator=g, dtype=torch.int8)
    scales = torch.rand(x.shape[0], generator=g) + 0.5
    args = (q, x, scales, None, torch.tensor([0, 0, 1, 2, 3, -1], dtype=torch.int32), starts, sizes)
    kw = dict(bl=bl, int8_dot=True, l2=False, packed=packed)
    s2, i2 = tprobe.probe_fold(*args, **kw)
    s1, i1 = tprobe.probe_fold(*args, **kw, top1=True)
    assert s1.shape == (6, tprobe.QU, tprobe.NBK)
    torch.testing.assert_close(s1.view(torch.int32), s2[:, :, : tprobe.NBK].view(torch.int32), rtol=0, atol=0)
    if not packed:
        torch.testing.assert_close(i1, i2[:, :, : tprobe.NBK], rtol=0, atol=0)


@pytest.mark.parametrize("spill_frac", [0.0, 0.2])
@pytest.mark.parametrize("packed_ok", [True, False])
def test_owned_lists_and_return_rows(tmp_path, spill_frac, packed_ok):
    """The sharded caller's inputs: candidates come only from the owned
    lists, bit for bit as the reference's (int8 dot), and the returned
    storage rows hold the returned ids, as the reference's rows do."""
    rng = np.random.default_rng(11)
    emb = _corpus(rng, 8192, 32)
    js, ts = _stores(tmp_path, emb, nlist=8, spill_frac=spill_frac)
    xq = _exact_scale(emb[:12] + 0.02 * rng.standard_normal((12, 32)).astype(np.float32))
    pl = _probe_lists(rng, 12, 8, 6)
    owned = np.zeros(8, bool)
    owned[[1, 2, 5]] = True
    ref, got = _run_both(js, ts, xq, pl, int8_queries=True, packed_ok=packed_ok, owned=owned, return_rows=True)
    _assert_pool_bitwise(ref, got)
    row_ids = ts["ivf_row_ids"].numpy()
    lists_of_rows = np.searchsorted(ts["ivf_list_start"].numpy(), np.arange(len(row_ids)), side="right") - 1
    for (s, i, r) in (ref, got):
        live = s > -1e38
        assert live.any() and (~live).any()
        assert owned[lists_of_rows[r[live]]].all()
        nz = live & (s != 0)  # a zero score loses its id in the reference (see _assert_pool_bitwise)
        np.testing.assert_array_equal(row_ids[r[nz]], i[nz])
    for q in range(12):
        live = ref[0][q] > -1e38
        assert sorted(ref[2][q][live].tolist()) == sorted(got[2][q][live].tolist()), q


@pytest.mark.parametrize("packed_ok", [True, False])
def test_shard_owning_none_of_the_probed_lists(tmp_path, packed_ok):
    """A shard that owns none of a batch's probed lists still runs K1 and
    gets only masked candidates, as the reference's probe does."""
    rng = np.random.default_rng(12)
    emb = _corpus(rng, 8192, 32)
    js, ts = _stores(tmp_path, emb, nlist=8)
    xq = _exact_scale(emb[:6])
    pl = np.argsort(rng.random((6, 4)), axis=1)[:, :3].astype(np.int32)  # lists 0-3 only
    owned = np.arange(8) >= 4
    launches = []

    def fold(*args, **kw):
        launches.append(1)
        return tprobe.probe_fold(*args, **kw)

    bl = int(ts["meta"]["block_align"])
    out = tprobe._grouped_probe(
        ts["centroids"], ts["ivf_vectors"], ts["ivf_row_ids"], ts["ivf_list_start"], ts["ivf_list_size"],
        torch.from_numpy(xq), ts["ivf_row_scales"], None, 10, 3, int(ts["meta"]["probe_window"]) // bl, "ip",
        True, owned=torch.from_numpy(owned), probe_lists=torch.from_numpy(pl), return_rows=True,
        packed_ok=packed_ok, bl=bl, spilled=False, fold=fold,
    )
    ref, got = _run_both(js, ts, xq, pl, int8_queries=True, packed_ok=packed_ok, owned=owned, return_rows=True,
                         k=10)
    assert launches == [1]
    for s, i, _ in (ref, got, tuple(t.numpy() for t in out)):
        assert (s <= -1e38).all() and (i == -1).all()


# (case, synth_pool arguments, k, spilled) for the pool stage's plain version
_POOL_CASES = [
    ("packed_bias_scale", dict(kc=128, packed=True, bias=True, scale=True), 24, False),
    ("packed_bias", dict(kc=128, packed=True, bias=True, scale=False), 24, False),
    ("packed_scale_last", dict(kc=128, packed=True, bias=False, scale=True), 24, False),
    ("unpacked_bias_scale", dict(kc=128, packed=False, bias=True, scale=True), 24, False),
    ("unpacked_kc64", dict(kc=64, packed=False, bias=False, scale=False), 10, False),
    ("packed_kc64_bias", dict(kc=64, packed=True, bias=True, scale=False), 10, False),
    ("empty_lists", dict(packed=True, empty=5), 24, False),
    ("owned_zeroed", dict(packed=True, zeroed=5), 24, False),
    ("owned_zeroed_unpacked", dict(packed=False, zeroed=5, bias=False, scale=False), 24, False),
    ("all_empty_query", dict(packed=True, all_empty_query=True), 24, False),
    ("ties", dict(packed=False, ties=True), 24, False),
    ("whole_pool_padded", dict(kc=64, packed=True, nprobe=3), 300, False),
    ("spilled_2k_dedup", dict(packed=False, bias=False, scale=False), 24, True),
    ("spilled_kc64_scale", dict(kc=64, packed=False, bias=False, scale=True), 24, True),
]


@pytest.mark.parametrize("case,kw,k,spilled", _POOL_CASES, ids=[c[0] for c in _POOL_CASES])
def test_pool_select_reference_against_numpy_pool(case, kw, k, spilled):
    """The pool stage's plain version (``pool_select_reference``) against
    each query's pool built pair by pair in numpy and sorted there, and
    ``finish_pool`` after it against the same steps in numpy."""
    kw = dict(kw)
    nprobe = kw.pop("nprobe", 12)
    inp = synth_pool(13, b=6, nprobe=nprobe, nlist=20, **kw)
    kc, packed = inp["cand_pk"].shape[-1], kw.get("packed", True)
    k_out = min(2 * k if spilled else k, nprobe * kc)
    names = ("cand_pk", "cand_idx", "padpos", "probe_lists", "list_start", "list_size", "probe_bias", "q_scales")
    top_s, top_rows = tprobe.pool_select(*(inp[n] for n in names), k_out=k_out, packed=packed,
                                         n_rows=inp["n_rows"])
    assert top_s.shape == top_rows.shape == (6, k_out) and top_rows.dtype == torch.int32
    pool_s, pool_r = numpy_pool(inp, packed=packed)
    assert_head(top_s.numpy(), top_rows.numpy(), pool_s, pool_r)
    if case == "all_empty_query":
        assert (top_s[0] <= -1e38).all() and (top_s[1:, 0] > -1e38).all()
    rng = np.random.default_rng(14)
    row_ids = torch.from_numpy(rng.integers(0, inp["n_rows"] // 2, inp["n_rows"]).astype(np.int32) if spilled
                               else rng.permutation(inp["n_rows"]).astype(np.int32))
    last_scale = inp["q_scales"] if inp["probe_bias"] is None else None
    got = tprobe.finish_pool(top_s, top_rows, row_ids, k, spilled=spilled, q_scales=last_scale)
    assert_finish(got, numpy_finish(top_s, top_rows, row_ids, k, spilled=spilled, q_scales=last_scale), k)
