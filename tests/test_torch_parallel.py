"""``lotus_tpu_torch.parallel`` (four gloo ranks on the CPU) held to
``lotus_tpu.parallel`` (``default_mesh(4)`` of the conftest's virtual
devices, the grouped probe in interpret mode) on the same inputs.

The ranks run once for the whole file (``torch_ranks.launch``, jax blocked
in them); each test compares one case's outputs.  The stores are built once
by the port's ``build_ivf`` and loaded by both packages, so both probe the
same lists.  Every rank must return the same merged result.

Tolerances: ids agree as sets per query, except where the two packages'
scores tie within the tolerance at the k-th place (named ``near_tie``);
int8-dot scores agree bit for bit; float scores within the tolerance of the
matching single-device test in ``test_torch_ivf_probe.py`` (f32 1e-5 in
K1's pool, 1e-4 after the merge, as ``test_parallel.py`` holds them; bf16
products 2e-2).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from lotus_tpu.ops import flat_search as jax_flat_search
from lotus_tpu.ops.ivf import load_ivf_state as jax_load
from lotus_tpu.parallel import default_mesh as jax_mesh
from lotus_tpu.parallel import distributed as jax_dist
from lotus_tpu.parallel import ivf as jax_pivf
from lotus_tpu.parallel import search as jax_psearch
from lotus_tpu.parallel.kmeans import _local_stats as jax_local_stats
from lotus_tpu_torch.ops import io as torch_io
from lotus_tpu_torch.ops.ivf import build_ivf as torch_build
from lotus_tpu_torch.ops.ivf import load_ivf_state as torch_load
from lotus_tpu_torch.parallel import distributed as torch_dist
from lotus_tpu_torch.parallel import ivf as torch_pivf

WORLD = 4
# Outputs that differ by rank by design: each rank's own shard.
_PER_RANK = ("owned_", "local_", "x_local", "n_local")
_JAX_DTYPE = {"float32": jnp.float32, "int8": jnp.int8}


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _clustered(rng, n, d, c=8, spread=0.15):
    centers = rng.standard_normal((c, d)).astype(np.float32)
    return _unit(centers[rng.integers(0, c, n)] + spread * rng.standard_normal((n, d)).astype(np.float32))


def _build(io, name, emb, nlist, **kw):
    encoding = kw.pop("encoding", None)
    path = str(io / name)
    meta = {"kind": "ivf", "metric": "ip", **torch_build(path, emb, nlist=nlist, metric="ip", device="cpu", **kw)}
    if encoding:
        meta["encoding"] = encoding
    torch_io.write_meta(path, meta)
    return path


def _store_inputs(io):
    """The inputs of every case, written where the ranks read them."""
    rng = np.random.default_rng(0)
    xb, xq = rng.standard_normal((1000, 32)).astype(np.float32), rng.standard_normal((5, 32)).astype(np.float32)
    np.savez(io / "flat.npz", xb=xb, xq=xq)
    rng = np.random.default_rng(1)
    np.savez(io / "flat_mask.npz", xb=rng.standard_normal((600, 16)).astype(np.float32),
             xq=rng.standard_normal((3, 16)).astype(np.float32), valid=rng.random(600) < 0.4)

    rng = np.random.default_rng(2)
    centers = rng.standard_normal((6, 16)).astype(np.float32) * 3
    x = np.concatenate([c + 0.05 * rng.standard_normal((300, 16)).astype(np.float32) for c in centers])
    # The reference's own init draw (jax.random.choice cannot be reproduced
    # by torch), so both fits start from the same centroids.
    init = x[np.sort(np.asarray(jax.random.choice(jax.random.PRNGKey(0), len(x), shape=(6,), replace=False)))]
    np.savez(io / "kmeans.npz", x=x, labels=np.repeat(np.arange(6), 300),
             c0=x[rng.choice(len(x), 6, replace=False)], init=init)

    window = {}
    rng = np.random.default_rng(5)
    emb = _unit(rng.standard_normal((2000, 32)).astype(np.float32))
    _build(io, "ivf_full", emb, 32)
    window["ivf_full"] = emb[:6] + 0.02 * rng.standard_normal((6, 32)).astype(np.float32)
    rng = np.random.default_rng(6)
    emb = _unit(rng.standard_normal((1500, 16)).astype(np.float32))
    _build(io, "ivf_partial", emb, 24)
    window["ivf_partial"] = emb[:4]
    rng = np.random.default_rng(7)
    emb = _unit(rng.standard_normal((2000, 32)).astype(np.float32))
    _build(io, "ivf8", emb, 16)
    window["ivf8"] = emb[:6] + 0.01 * rng.standard_normal((6, 32)).astype(np.float32)
    rng = np.random.default_rng(31)
    emb = _clustered(rng, 4096, 32)
    _build(io, "wrsc", emb, 8, encoding="residual_int8")
    window["wrsc"] = emb[:4] + 0.01 * rng.standard_normal((4, 32)).astype(np.float32)
    rng = np.random.default_rng(42)
    centers = rng.standard_normal((256, 48)).astype(np.float32) * 2
    emb = _unit(centers[rng.integers(0, 256, 131072)] + 0.3 * rng.standard_normal((131072, 48)).astype(np.float32))
    _build(io, "scale", emb, 128)
    window["scale"] = emb[rng.choice(131072, 64, replace=False)] + 0.02 * rng.standard_normal((64, 48)).astype(
        np.float32)
    np.savez(io / "window.npz", **window)

    grouped = {}
    for name, seed, kw in (("blk", 9, {}), ("blk8", 10, {}), ("rsc", 21, dict(encoding="residual_int8")),
                           ("spill", 4, dict(spill_frac=0.2))):
        rng = np.random.default_rng(seed)
        emb = _clustered(rng, 6144, 32, spread=0.3 if name != "rsc" else 0.15)
        _build(io, name, emb, 8, block_align=512, **kw)
        grouped[name] = emb[:8] + 0.02 * rng.standard_normal((8, 32)).astype(np.float32)
    np.savez(io / "grouped.npz", **grouped)

    rng = np.random.default_rng(12)
    emb = rng.standard_normal((4096, 16)).astype(np.float32)
    for name in ("rt_port", "rt_jax"):
        _build(io, name, emb, 8)
    path = str(io / "rt_jax")
    meta = torch_io.read_meta(path)
    host = jax_load(path, meta, jnp.float32, device=False)
    host["meta"] = meta
    jax_pivf.save_ivf_shards(path, host, WORLD)
    np.savez(io / "roundtrip.npz", xq=emb[:6])

    rng = np.random.default_rng(11)
    emb = _unit(rng.standard_normal((512 * 8, 32)).astype(np.float32))
    xq = emb[:8] + 0.01 * rng.standard_normal((8, 32)).astype(np.float32)
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((16, 32)).astype(np.float32)
    auto_emb = _unit(centers[rng.integers(0, 16, 4096)] + 0.15 * rng.standard_normal((4096, 32)).astype(np.float32))
    rng = np.random.default_rng(9)
    flat_emb = _unit(rng.standard_normal((600, 32)).astype(np.float32))
    np.savez(io / "store.npz", emb=emb, xq=xq, allowed=np.arange(0, len(emb), 3), auto_emb=auto_emb,
             flat_emb=flat_emb, flat_xq=flat_emb[:4] + 0.02 * rng.standard_normal((4, 32)).astype(np.float32),
             flat_allowed=np.arange(0, 600, 3))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    io = tmp_path_factory.mktemp("ranks")
    _store_inputs(io)
    torch_ranks.launch(str(io), ["flat", "kmeans", "window", "grouped", "roundtrip", "store"], world=WORLD)
    return io


@pytest.fixture(scope="module")
def mesh():
    return jax_mesh(WORLD)


def _out(io, case):
    """Rank 0's outputs of a case, after checking every rank returned the
    same replicated results; and every rank's outputs."""
    outs = [dict(np.load(io / f"{case}.rank{r}.npz")) for r in range(WORLD)]
    for key, val in outs[0].items():
        if not key.startswith(_PER_RANK):
            for r in range(1, WORLD):
                np.testing.assert_array_equal(outs[r][key], val, err_msg=f"{case}:{key} rank {r}")
    return outs[0], outs


def _jax_state(io, name, dtype="float32"):
    path = str(io / name)
    meta = torch_io.read_meta(path)
    state = jax_load(path, meta, _JAX_DTYPE[dtype])
    state.setdefault("meta", meta)
    return state


def _same_sets(got_i, ref_i, ref_d=None, tol=0.0, got_d=None):
    """Per-query set equality; a query whose sets differ passes only at a
    near-tie: the two sets' lowest scores agree within ``tol``."""
    got_i, ref_i = np.asarray(got_i), np.asarray(ref_i)
    for q in range(ref_i.shape[0]):
        if set(got_i[q].tolist()) != set(ref_i[q].tolist()):
            assert ref_d is not None and got_d is not None, q
            near_tie = abs(np.min(got_d[q]) - np.min(ref_d[q])) <= tol
            assert near_tie, (q, got_i[q], ref_i[q])


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_sharded_flat_matches_reference(ranks, mesh, metric):
    out, _ = _out(ranks, "flat")
    z = np.load(ranks / "flat.npz")
    if metric == "ip":  # one case against the reference's own sharded search
        xb_sh, n = jax_mesh_rows(z["xb"], mesh, 64)
        sh_d, sh_i = jax_psearch.sharded_flat_search(
            xb_sh, jnp.asarray(z["xq"]), 10, n_rows=n, metric=metric, mesh=mesh, block_rows=64)
        np.testing.assert_allclose(out[f"d_{metric}"], np.asarray(sh_d), rtol=1e-4, atol=1e-4)
        _same_sets(out[f"i_{metric}"], sh_i, np.asarray(sh_d), 1e-4, out[f"d_{metric}"])
    ref_d, ref_i = jax_flat_search(jnp.asarray(z["xb"]), jnp.asarray(z["xq"]), 10, metric=metric)
    np.testing.assert_allclose(out[f"d_{metric}"], np.asarray(ref_d), rtol=1e-4, atol=1e-4)
    assert (out[f"i_{metric}"] == np.asarray(ref_i)).mean() > 0.99


def jax_mesh_rows(x, mesh, block_rows):
    from lotus_tpu.parallel import shard_rows

    return shard_rows(jnp.asarray(x), mesh, block_rows=block_rows)


def test_sharded_flat_with_subset_mask(ranks):
    out, _ = _out(ranks, "flat")
    z = np.load(ranks / "flat_mask.npz")
    idx = out["i_mask"]
    assert z["valid"][idx[idx >= 0]].all()
    ref_d, ref_i = jax_flat_search(jnp.asarray(z["xb"]), jnp.asarray(z["xq"]), 5, valid=jnp.asarray(z["valid"]))
    np.testing.assert_allclose(out["d_mask"], np.asarray(ref_d), rtol=1e-4, atol=1e-4)
    _same_sets(idx, ref_i, np.asarray(ref_d), 1e-4, out["d_mask"])


def test_sharded_kmeans_step_matches_psum(ranks):
    """One step's (sums, counts, score) against the reference's
    ``_local_stats`` over the same four shards, summed as ``psum`` sums."""
    out, outs = _out(ranks, "kmeans")
    c0 = jnp.asarray(np.load(ranks / "kmeans.npz")["c0"])
    parts = [jax_local_stats(jnp.asarray(o["x_local"]), c0, int(o["n_local"]), 6, "l2", 128) for o in outs]
    sums, counts, score = (np.sum([np.asarray(p[i]) for p in parts], axis=0) for i in range(3))
    np.testing.assert_array_equal(out["counts"], counts)
    np.testing.assert_allclose(out["sums"], sums, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out["score"], score, rtol=1e-5)


def test_sharded_kmeans_matches_quality(ranks, mesh):
    """The reference's quality check on a fit from the reference's own init
    draw, whose centroids and inertia equal ``sharded_kmeans_fit``'s; a fit
    from the port's seeded draw returns every row's assignment."""
    from lotus_tpu.parallel import sharded_kmeans_fit

    out, _ = _out(ranks, "kmeans")
    z = np.load(ranks / "kmeans.npz")
    labels = z["labels"]
    assign = out["assign"]
    assert assign.shape == (len(labels),) and out["seeded_assign"].shape == (len(labels),)
    for c in range(6):
        _, counts = np.unique(assign[labels == c], return_counts=True)
        assert counts.max() / counts.sum() > 0.99
    x_sh, n = jax_mesh_rows(z["x"], mesh, 8)
    ref = sharded_kmeans_fit(x_sh, 6, n_rows=n, mesh=mesh, iters=10, key=jax.random.PRNGKey(0), block_rows=128)
    np.testing.assert_array_equal(assign, np.asarray(ref.assignments))
    np.testing.assert_allclose(out["centroids"], np.asarray(ref.centroids), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out["inertia"], np.asarray(ref.inertia), rtol=1e-4)
    assert np.isfinite(out["seeded_inertia"])


def _window_ref(io, name, dtype, nprobe, k, rescore=None):
    """The reference's single-device window probe on the same store: what
    ``test_parallel.py`` holds the reference's sharded probe to (its
    ``shard_map`` recompiles at every call, about 10 s each on the CPU)."""
    from lotus_tpu.ops.ivf import ivf_search

    xq = jnp.asarray(np.load(io / "window.npz")[name])
    d, i = ivf_search(_jax_state(io, name, dtype), xq, k, nprobe=nprobe, metric="ip", rescore=rescore)
    return np.asarray(d), np.asarray(i)


def test_sharded_ivf_matches_reference(ranks):
    out, _ = _out(ranks, "window")
    ref_d, ref_i = _window_ref(ranks, "ivf_full", "float32", 32, 10)
    # nprobe == nlist: exhaustive on both sides.
    _same_sets(out["i_ivf_full_float32_None"], ref_i, ref_d, 1e-5, out["d_ivf_full_float32_None"])
    np.testing.assert_allclose(np.sort(out["d_ivf_full_float32_None"]), np.sort(ref_d), rtol=1e-4, atol=1e-4)


def test_sharded_ivf_partial_probe(ranks):
    out, _ = _out(ranks, "window")
    got = out["i_ivf_partial_float32_None"]
    assert all(q in got[q] for q in range(4))  # each query's own row is found
    ref_d, ref_i = _window_ref(ranks, "ivf_partial", "float32", 6, 5)
    _same_sets(got, ref_i, ref_d, 1e-5, out["d_ivf_partial_float32_None"])


def test_sharded_ivf_int8_matches_float(ranks):
    out, _ = _out(ranks, "window")
    i_f, i_q = out["i_ivf8_float32_None"], out["i_ivf8_int8_None"]
    assert (i_q[:, 0] == i_f[:, 0]).all()
    assert np.mean([len(set(i_q[r]) & set(i_f[r])) / 5 for r in range(6)]) >= 0.9
    ref_d, ref_i = _window_ref(ranks, "ivf8", "int8", 16, 5)
    _same_sets(i_q, ref_i, ref_d, 2e-2, out["d_ivf8_int8_None"])


def test_sharded_window_probe_rescore(ranks):
    """Shard-local exact rescoring in the window probe equals the
    reference's; without it the int8 sets stay close to the reference's."""
    out, _ = _out(ranks, "window")
    plain, resc = out["i_wrsc_int8_None"], out["i_wrsc_int8_32"]
    ref_d, ref_i = _window_ref(ranks, "wrsc", "int8", 8, 5, rescore=32)
    _same_sets(resc, ref_i, ref_d, 1e-5, out["d_wrsc_int8_32"])
    ref_pd, ref_plain = _window_ref(ranks, "wrsc", "int8", 8, 5)
    _same_sets(plain, ref_plain, ref_pd, 2e-2, out["d_wrsc_int8_None"])


def test_sharded_ivf_recall_at_scale(ranks):
    """recall@10 >= 0.95 against the exact oracle at nprobe 16 of 128, and
    every shard owns a share of the rows (the reference's own gate); each
    rank owns the lists the reference's plan gives it."""
    out, outs = _out(ranks, "window")
    state = torch_load(str(ranks / "scale"), torch_io.read_meta(str(ranks / "scale")), torch.float32, device="cpu")
    vecs = state["ivf_vectors"].numpy()
    ids = state["ivf_row_ids"].numpy()
    emb = np.zeros((131072, 48), np.float32)
    emb[ids[ids >= 0]] = vecs[ids >= 0]
    xq = np.load(ranks / "window.npz")["scale"]
    _, ref = jax_flat_search(jnp.asarray(emb), jnp.asarray(xq), 10, metric="ip")
    ref = np.asarray(ref)
    got = out["i_scale_float32_None"]
    recall = np.mean([len(set(got[q]) & set(ref[q])) / 10 for q in range(64)])
    assert recall >= 0.95, recall
    host = jax_load(str(ranks / "scale"), torch_io.read_meta(str(ranks / "scale")), jnp.float32, device=False)
    host["meta"] = torch_io.read_meta(str(ranks / "scale"))
    _, plan = jax_pivf.plan_ivf_shards(host, WORLD)
    owned = np.stack([o["owned_scale_float32_None"] for o in outs])
    np.testing.assert_array_equal(owned, np.stack([p["owned"] for p in plan]))
    sizes = state["ivf_list_size"].numpy()
    assert ((owned * sizes[None, :]).sum(axis=1) > 0.02 * 131072).all()


def _grouped_ref(io, name, dtype, k, mesh=None, **kw):
    """The reference's grouped probe in interpret mode on the same store:
    sharded over ``mesh``, or on one device, which ``test_parallel.py``
    holds the sharded probe to."""
    from lotus_tpu.ops.pallas_ivf import ivf_search_pallas

    state = _jax_state(io, name, dtype)
    xq = jnp.asarray(np.load(io / "grouped.npz")[name])
    if mesh is None:
        d, i = ivf_search_pallas(state, xq, k, nprobe=8, metric="ip", interpret=True, **kw)
    else:
        d, i = jax_pivf.sharded_ivf_search_pallas(
            jax_pivf.shard_ivf_state(state, mesh), xq, k, nprobe=8, metric="ip", interpret=True, **kw)
    return np.asarray(d), np.asarray(i)


def test_sharded_pallas_probe_matches_reference(ranks, mesh):
    out, _ = _out(ranks, "grouped")
    ref_d, ref_i = _grouped_ref(ranks, "blk", "float32", 10, mesh=mesh)
    _same_sets(out["i_blk_"], ref_i, ref_d, 1e-5, out["d_blk_"])
    np.testing.assert_allclose(np.sort(out["d_blk_"], axis=1), np.sort(ref_d, axis=1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("int8_queries", [False, True])
def test_sharded_pallas_probe_int8(ranks, int8_queries):
    out, _ = _out(ranks, "grouped")
    tag = "blk8_int8_queriesTrue" if int8_queries else "blk8_"
    got = out[f"i_{tag}"]
    assert all(q in got[q] for q in range(8))  # own row always found
    ref_d, ref_i = _grouped_ref(ranks, "blk8", "int8", 5, int8_queries=int8_queries)
    if int8_queries:  # the int8 dot and one scale: bit for bit
        np.testing.assert_array_equal(out[f"d_{tag}"], ref_d)
        _same_sets(got, ref_i)
    else:
        _same_sets(got, ref_i, ref_d, 2e-2, out[f"d_{tag}"])
        np.testing.assert_allclose(out[f"d_{tag}"], ref_d, rtol=2e-2, atol=2e-2)


def test_sharded_pallas_rescore_matches_reference(ranks):
    """Shard-local exact rescoring equals the reference's; query_chunk
    slicing changes nothing; int8 queries under the rescore too."""
    out, _ = _out(ranks, "grouped")
    assert (ranks / "rsc").exists()
    ref_d, ref_i = _grouped_ref(ranks, "rsc", "int8", 5, rescore=32)
    _same_sets(out["i_rsc_rescore32"], ref_i, ref_d, 1e-5, out["d_rsc_rescore32"])
    np.testing.assert_allclose(out["d_rsc_rescore32"], ref_d, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out["i_rsc_rescore32_query_chunk3"], out["i_rsc_rescore32"])
    ref_d8, ref_i8 = _grouped_ref(ranks, "rsc", "int8", 5, rescore=32, int8_queries=True)
    _same_sets(out["i_rsc_rescore32_int8_queriesTrue"], ref_i8, ref_d8, 1e-5, out["d_rsc_rescore32_int8_queriesTrue"])


def test_sharded_pallas_spilled_dedups(ranks):
    """A spilled row can reach two shards: it comes back once."""
    out, outs = _out(ranks, "grouped")
    for row in out["i_spill_"]:
        live = [v for v in row.tolist() if v >= 0]
        assert len(live) == len(set(live))
    ref_d, ref_i = _grouped_ref(ranks, "spill", "float32", 10)
    _same_sets(out["i_spill_"], ref_i, ref_d, 1e-5, out["d_spill_"])
    # Some id did come from two ranks' local top-k.
    local = [o["local_spill_"] for o in outs]
    twice = sum(len(set(a[q]) & set(b[q]) - {-1}) for q in range(8)
                for i, a in enumerate(local) for b in local[i + 1:])
    assert twice > 0


@pytest.mark.parametrize("tag", ["blk_", "blk8_int8_queriesTrue", "rsc_rescore32"])
def test_local_candidates_owned_and_disjoint(ranks, tag):
    """Each rank's local top-k lies in lists it owns, and on an unspilled
    store no id comes back from two ranks."""
    _, outs = _out(ranks, "grouped")
    assert all(bool(o[f"owned_ok_{tag}"]) for o in outs)
    local = [o[f"local_{tag}"] for o in outs]
    for q in range(local[0].shape[0]):
        seen = [v for a in local for v in a[q].tolist() if v >= 0]
        assert len(seen) == len(set(seen)), q


def test_hybrid_mesh_single_process():
    assert torch_dist.init_runtime() is False  # no torchrun environment: a no-op
    m = torch_dist.hybrid_mesh(device="cpu")
    assert m.shape[torch_dist.HOST_AXIS] == 1
    assert m.shape[torch_dist.CHIP_AXIS] == 1
    assert torch_dist.serving_mesh(device="cpu").shape == {"shard": 1}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_index_shard_roundtrip_across_packages(tmp_path, writer):
    save = (jax_dist if writer == "jax" else torch_dist).save_index_shards
    load = torch_dist if writer == "jax" else jax_dist
    rng = np.random.default_rng(3)
    root = str(tmp_path / "sharded_idx")
    arrays = []
    for sid in range(3):
        arrays.append({"vectors": rng.standard_normal((40 + sid, 8)).astype(np.float32),
                       "row_ids": np.arange(40 + sid, dtype=np.int32)})
        save(root, arrays[-1], shard_id=sid, num_shards=3, meta={"metric": "ip"})
    man = load.shard_manifest(root)
    assert man["num_shards"] == 3 and len(man["shards"]) == 3 and man["format_version"] == 1
    back = load.load_index_shard(root, 1)
    np.testing.assert_array_equal(back["vectors"], arrays[1]["vectors"])
    np.testing.assert_array_equal(back["row_ids"], arrays[1]["row_ids"])
    assert os.path.exists(os.path.join(root, "shard_00002", "vectors.npy"))
    with pytest.raises(FileNotFoundError):
        load.load_index_shard(root, 9)


@pytest.mark.parametrize(
    "dtype,kw",
    [("float32", {}), ("int8", dict(encoding="residual_int8")), ("float32", dict(spill_frac=0.2)),
     ("int8", dict(spill_frac=0.2, encoding="residual_int8"))],
)
def test_plan_ivf_shards_bit_for_bit(tmp_path, dtype, kw):
    rng = np.random.default_rng(8)
    emb = _clustered(rng, 6144, 32)
    block = {"block_align": 512} if "spill_frac" in kw else {}
    path = _build(tmp_path, "plan", emb, 8, **block, **kw)
    meta = torch_io.read_meta(path)
    js = jax_load(path, meta, _JAX_DTYPE[dtype], device=False)
    js.setdefault("meta", meta)
    ts = torch_load(path, meta, getattr(torch, dtype), device="cpu")
    ts.setdefault("meta", meta)
    ref_meta, ref = jax_pivf.plan_ivf_shards(js, 3)
    got_meta, got = torch_pivf.plan_ivf_shards(ts, 3)
    assert got_meta == ref_meta
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for name in r:
            assert g[name].dtype == np.asarray(r[name]).dtype, name
            np.testing.assert_array_equal(g[name], np.asarray(r[name]), err_msg=name)


def test_save_load_sharded_roundtrip(ranks, mesh):
    """In-memory shards, port-written shards and reference-written shards
    give one result on the port's ranks; the reference loads the port's
    shards and agrees; the files are the same; a mesh of half the size is
    refused."""
    out, _ = _out(ranks, "roundtrip")
    for name in ("rt_port", "rt_jax"):
        np.testing.assert_array_equal(out[f"i_{name}"], out["i_mem"])
        np.testing.assert_array_equal(out[f"d_{name}"], out["d_mem"])
    assert bool(out["refused"])
    path = str(ranks / "rt_port")
    disk = jax_pivf.load_sharded_ivf_state(path, torch_io.read_meta(path), mesh)
    mem = jax_pivf.shard_ivf_state(_jax_state(ranks, "rt_port"), mesh)
    for name in ("vecs", "row_ids", "list_start", "owned", "row_list", "centroids", "list_size"):
        np.testing.assert_array_equal(np.asarray(disk[name]), np.asarray(mem[name]), err_msg=name)
    from lotus_tpu.ops.ivf import ivf_search

    xq = jnp.asarray(np.load(ranks / "roundtrip.npz")["xq"])
    ref_d, ref_i = ivf_search(_jax_state(ranks, "rt_port"), xq, 5, nprobe=8, metric="ip")
    _same_sets(out["i_mem"], np.asarray(ref_i), np.asarray(ref_d), 1e-5, out["d_mem"])
    np.testing.assert_allclose(out["d_mem"], np.asarray(ref_d), rtol=1e-5, atol=1e-5)
    assert jax_dist.shard_manifest(path)["meta"] == jax_dist.shard_manifest(str(ranks / "rt_jax"))["meta"]
    for sid in range(WORLD):
        a = torch_dist.load_index_shard(path, sid)
        b = torch_dist.load_index_shard(str(ranks / "rt_jax"), sid)
        assert sorted(a) == sorted(b)
        for name in a:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_torchvs_config5_lifecycle(ranks, mesh):
    """``index()`` persists the shards, a fresh store reloads only its shard,
    the sharded probe equals a single-device store as sets, the reference's
    ``TpuVS`` on the same files agrees, and the ids path on the shard-only
    state scans the allowed rows exactly."""
    from lotus_tpu.vector_store.tpu_vs import TpuVS

    out, _ = _out(ranks, "store")
    z = np.load(ranks / "store.npz")
    emb, xq, allowed = z["emb"], z["xq"], z["allowed"]
    assert (ranks / "cfg5" / "shards.json").exists()
    assert bool(out["shard_only"]) and bool(out["no_flat_copy"])
    assert out["routes"].tolist() == [1, 0, 0]
    _same_sets(out["ids"], out["solo"])

    server = TpuVS(index_type="ivf", metric="ip", device_dtype="int8", nprobe=8, mesh=mesh, rescore=8)
    server._pallas_interpret = True
    server.load_index(str(ranks / "cfg5"))
    ref = server(xq, 5)
    assert "ivf_sharded" in server._state and "ivf_vectors" not in server._state
    _same_sets(out["ids_bf16"], ref.indices)

    allowed_set = set(allowed.tolist())
    assert all(v in allowed_set or v == -1 for v in out["sub"].reshape(-1).tolist())
    sims = xq @ emb[allowed].T
    for q in range(len(xq)):
        assert set(out["sub"][q].tolist()) == {int(allowed[j]) for j in np.argsort(-sims[q])[:5]}
    ref_sub = server(xq, 5, ids=allowed.tolist())
    np.testing.assert_allclose(out["sub_d"], np.asarray(ref_sub.distances), rtol=1e-5, atol=1e-5)
    # Calibration through the sharded probe: every rank adopts one result
    # (``_out`` holds them equal) and rank 0 persists it once.
    entry = torch_io.read_meta(str(ranks / "cfg5"))["calibration"]["0.9@5"]
    assert [entry["nprobe"], entry["recall"]] == out["cal"].tolist()
    assert entry["regimes"] == ["pallas"]


def test_torchvs_mesh_routes_unaligned_store(ranks):
    """An unaligned store under the mesh: B 1 through the sharded window
    probe, B 8 at nprobe 8 (B * nprobe = nlist) through the sharded scan;
    both equal ``TpuVS`` on the same files (on one device: its sharded
    probe is held to that by ``test_parallel.py``)."""
    from lotus_tpu.vector_store.tpu_vs import TpuVS

    out, _ = _out(ranks, "store")
    assert out["win_routes"].tolist() == [0, 1, 1]
    xq = np.load(ranks / "store.npz")["xq"]
    ref = TpuVS(index_type="ivf", metric="ip", nprobe=4)
    ref.load_index(str(ranks / "cfg5_window"))
    _same_sets(out["win_one"], ref(xq[:1], 5).indices)
    _same_sets(out["win_many"], ref(xq, 5, nprobe=8).indices)


def test_calibrate_on_sharded_store(ranks, tmp_path):
    """``tests/test_autotune.py``'s sharded case: the ladder probes ride the
    sharded window probe and the chosen point persists; the reference's
    calibration of the same files on one device picks the same nprobe (its
    sharded probe is held to that one by ``test_parallel.py``)."""
    import json
    import shutil

    from lotus_tpu.vector_store.tpu_vs import TpuVS

    out, _ = _out(ranks, "store")
    nprobe, recall, adopted = out["auto"].tolist()
    assert recall >= 0.95 and 1 <= nprobe < 16 and adopted == nprobe
    path = ranks / "auto_sharded"
    with open(path / "meta.json") as f:
        assert "calibration" in json.load(f)
    ref_dir = tmp_path / "ref"
    shutil.copytree(path, ref_dir)
    meta = torch_io.read_meta(str(ref_dir))
    meta.pop("calibration")
    torch_io.write_meta(str(ref_dir), meta)
    ref = TpuVS(index_type="ivf", nlist=16, nprobe=1)
    ref.load_index(str(ref_dir))
    want = ref.calibrate_nprobe(0.95, k=10, nq=64)
    assert want["nprobe"] == nprobe and abs(want["recall"] - recall) <= 0.02


def test_sharded_int8_flat_store(ranks):
    """The reference's int8 + mesh check; the sets equal an int8 ``TpuVS``
    over the same rows."""
    from lotus_tpu.vector_store.tpu_vs import TpuVS

    out, _ = _out(ranks, "store")
    z = np.load(ranks / "store.npz")
    emb, q = z["flat_emb"], z["flat_xq"]
    want = np.argsort(-(q @ emb.T), axis=1)[:, :5]
    assert np.mean([len(set(out["flat"][i]) & set(want[i])) / 5 for i in range(4)]) >= 0.9
    ref = TpuVS(device_dtype="int8", block_rows=32)
    ref.index([], emb, str(ranks / "flat_int8_ref"))
    _same_sets(out["flat"], ref(q, 5).indices)
    allowed = set(z["flat_allowed"].tolist())
    assert all(v in allowed for v in out["flat_sub"].reshape(-1).tolist())
    _same_sets(out["flat_sub"], ref(q, 5, ids=sorted(allowed)).indices)


class _StackedMesh:
    """A mesh whose all-gather returns the given per-rank tensors, to drive
    ``merge_shard_topk`` in one process."""

    def __init__(self, parts):
        self.parts, self.size = parts, WORLD

    def all_gather(self, t):
        got = [p for p in self.parts if p.dtype == t.dtype]
        return torch.stack(got)


@pytest.mark.parametrize("dedup", [False, True])
def test_merge_shard_topk_keeps_ids_exact(dedup):
    """The merge gathers the f32 scores and the int32 ids apart: ids near
    2**31 and the -1 of an empty slot come back as they went in, with the
    score-sorted top-k (and, under ``dedup``, each id once, at its best
    score) of every rank's candidates."""
    from lotus_tpu_torch.ops.common import NO_HIT
    from lotus_tpu_torch.parallel.ivf import merge_shard_topk

    rng = np.random.default_rng(17)
    k, b = 5, 3
    scores = [torch.from_numpy(-np.sort(-rng.standard_normal((b, k)).astype(np.float32), axis=1)) for _ in range(WORLD)]
    big = 2**31 - 1
    ids = [torch.tensor([[big - r * k - j for j in range(k)] for _ in range(b)], dtype=torch.int32)
           for r in range(WORLD)]
    ids[1][:, -2:] = NO_HIT
    scores[1][:, -2:] = torch.finfo(torch.float32).min
    if dedup:
        ids[2][:, 0] = ids[0][:, 0]  # one id from two ranks
    top_s, top_i = merge_shard_topk(_StackedMesh(scores + ids), scores[0], ids[0], k, dedup=dedup)
    for q in range(b):
        best = {}
        for s, i in zip(np.concatenate([x[q].numpy() for x in scores]), np.concatenate([x[q].numpy() for x in ids])):
            if i != NO_HIT and s > best.get(int(i), -np.inf):
                best[int(i)] = s
        want = sorted(best.items(), key=lambda kv: -kv[1])[:k]
        assert top_i[q].dtype == torch.int32
        assert top_i[q].tolist() == [i for i, _ in want]
        np.testing.assert_array_equal(top_s[q].numpy(), np.array([s for _, s in want], np.float32))


def test_bf16_shards_round_trip(tmp_path):
    """numpy has no bfloat16: bf16 shard rows are written as their 16-bit
    patterns and read back as the same bf16 rows."""
    from lotus_tpu_torch.parallel import ShardMesh

    rng = np.random.default_rng(13)
    path = _build(tmp_path, "bf16", _clustered(rng, 4096, 16), 8)
    meta = torch_io.read_meta(path)
    state = torch_load(path, meta, torch.bfloat16, device="cpu")
    state.setdefault("meta", meta)
    torch_pivf.save_ivf_shards(path, state, 2)
    assert torch_dist.shard_manifest(path)["meta"]["vec_dtype"] == "bfloat16"
    for slot in range(2):
        mesh = ShardMesh(None, [0, 1], slot, "cpu")
        disk = torch_pivf.load_sharded_ivf_state(path, meta, mesh)
        mem = torch_pivf.shard_ivf_state(state, mesh)
        assert disk["vecs"].dtype == torch.bfloat16
        for name in ("vecs", "row_ids", "list_start", "owned", "row_list", "centroids", "list_size"):
            assert torch.equal(disk[name], mem[name]), name
