"""The M6 gate: the scenarios of ``tests/test_vector_store.py`` and
``tests/test_sem_ops_retrieval.py`` with ``TorchVS(device="cpu")`` as the
store.  Each keeps its original checks and gives the same rows as
``TpuVS``:

- store scenarios: the port builds the index (its own k-means and layout);
  ``TpuVS`` loads that directory with ``_pallas_interpret`` set, so it takes
  the planner branches it takes on a TPU, and the port's and the
  reference's top-k sets must be equal per query;
- operator scenarios: each package's store runs the same pandas operators
  behind ``lotus_tpu.settings`` and the frames they return must be equal.

Left out: the sharded cases, which ``test_torch_parallel.py`` holds on four
gloo ranks, and ``test_external_stores_gate_on_missing_clients``, which has
no counterpart in the port.  With the port's store configured, ``sem_cluster_by`` and
``sem_partition_by`` run the port's ``cluster`` (``lotus_tpu_torch.utils``,
selected by assigning ``bind_cluster(vs)`` to ``lotus_tpu.utils.cluster``)
with JAX's k-means blocked; the two packages seed k-means with different
random numbers, so their partitions are compared up to relabelling.  The
ops-level mirrors of ``test_grouped_probe_matches_window_probe``
and ``test_grouped_probe_l2`` are in ``tests/test_torch_window_probe.py``.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import lotus_tpu
from lotus_tpu.models import HashRM
from lotus_tpu.vector_store import TpuVS
from lotus_tpu_torch import TorchVS
from lotus_tpu_torch.utils import bind_cluster


@pytest.fixture
def data():
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((1200, 64)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    queries = emb[:8] + 0.02 * rng.standard_normal((8, 64)).astype(np.float32)
    return emb, queries


def brute_topk(emb, queries, k):
    return np.argsort(-(queries @ emb.T), axis=1)[:, :k]


def _recall(got, ref, k):
    got = np.asarray(got)
    return np.mean([len(set(got[i]) & set(ref[i])) / k for i in range(len(ref))])


def _clustered(seed, n, d=64, c=32):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((c, d)).astype(np.float32)
    emb = centers[rng.integers(0, c, n)] * 2.5 + rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = emb[rng.integers(0, n, 16)] + 0.05 * rng.standard_normal((16, d)).astype(np.float32)
    return emb, q / np.linalg.norm(q, axis=1, keepdims=True)


def _pair(tmp_path, emb, **kw):
    """The port builds the index; TpuVS loads the same directory."""
    d = str(tmp_path / "idx")
    port = TorchVS(device="cpu", **kw)
    port.index([str(i) for i in range(len(emb))], emb, d)
    ref = TpuVS(**kw)
    ref._pallas_interpret = True  # the reference's on-device planner branches
    ref.load_index(d)
    return port, ref


# name -> (store kwargs, query rows, K, ids, check(port output, port, emb, queries))
SCENARIOS = {
    "flat_build_and_search": (
        {}, slice(None), 10, None,
        lambda out, vs, emb, q: _recall(out.indices, brute_topk(emb, q, 10), 10) == 1.0),
    "int8_store_recall": (
        dict(device_dtype="int8"), slice(None), 10, None,
        lambda out, vs, emb, q: _recall(out.indices, brute_topk(emb, q, 10), 10) >= 0.95),
    "subset_search_masks": (
        {}, slice(None), 5, list(range(0, 1200, 7)),
        lambda out, vs, emb, q: set(np.ravel(out.indices)) <= set(range(0, 1200, 7))
        and (np.asarray(out.indices) == np.arange(0, 1200, 7)[brute_topk(emb[::7], q, 5)]).mean() > 0.99),
    "ivf_build_and_recall": (  # nprobe == nlist: exact
        dict(index_type="ivf", nlist=16, nprobe=16), slice(None), 10, None,
        lambda out, vs, emb, q: _recall(out.indices, brute_topk(emb, q, 10), 10) == 1.0),
    "ivf_partial_probe_recall": (
        dict(index_type="ivf", nlist=16, nprobe=8), slice(None), 10, None,
        lambda out, vs, emb, q: np.mean(np.asarray(out.indices)[:, 0] == brute_topk(emb, q, 1)[:, 0]) >= 0.9
        and _recall(out.indices, brute_topk(emb, q, 10), 10) >= 0.5),
    "ivf_probe_path_small_batch": (  # 1 * 8 < 64: the window probe
        dict(index_type="ivf", nlist=64, nprobe=8), slice(0, 1), 5, None,
        lambda out, vs, emb, q: (np.asarray(out.indices) >= 0).all()
        and brute_topk(emb, q, 1)[0, 0] in out.indices[0] and vs.stats["routes"]["window_probe"] == 1),
    "ivf_regime_planner_scans_at_large_batch": (  # 8 * 8 >= 16: the exhaustive scan
        dict(index_type="ivf", nlist=16, nprobe=8), slice(None), 10, None,
        lambda out, vs, emb, q: (np.asarray(out.indices) == brute_topk(emb, q, 10)).mean() > 0.99
        and vs.stats["routes"]["scan"] == 1),
    "int8_ivf_falls_back_safely": (  # window probe over int8 rows
        dict(index_type="ivf", nlist=32, nprobe=4, device_dtype="int8"), slice(0, 1), 5, None,
        lambda out, vs, emb, q: brute_topk(emb, q, 1)[0, 0] in out.indices[0]),
    "ivf_subset_search_is_exact": (
        dict(index_type="ivf", nlist=16, nprobe=4), slice(None), 5, list(range(0, 1200, 7)),
        lambda out, vs, emb, q: np.array_equal(np.asarray(out.indices), np.arange(0, 1200, 7)[brute_topk(emb[::7], q, 5)])
        and "xb" not in vs._state and vs.stats["subset_searches"] == 1),
    "ivf_subset_search_int8": (
        dict(index_type="ivf", nlist=16, nprobe=4, device_dtype="int8"), slice(None), 5,
        list(range(0, 1200, 3)),
        lambda out, vs, emb, q: set(np.ravel(out.indices)) <= set(range(0, 1200, 3))
        and (np.asarray(out.indices)[:, 0] == np.arange(0, 1200, 3)[brute_topk(emb[::3], q, 1)[:, 0]]).mean() >= 0.9),
    "flat_int8_rescore_default": (
        dict(index_type="flat", metric="ip", device_dtype="int8"), slice(None), 10, None,
        lambda out, vs, emb, q: _recall(out.indices, brute_topk(emb, q, 10), 10) >= 0.95
        and all(np.allclose(out.distances[r][c], q[r] @ emb[out.indices[r][c]], rtol=2e-2)
                for r in range(3) for c in range(3))),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_store_scenario_matches_reference(tmp_path, data, name):
    kw, rows, k, ids, check = SCENARIOS[name]
    emb, queries = data
    q = queries[rows]
    port, ref = _pair(tmp_path, emb, **kw)
    out = port(q, k, ids=ids)
    assert check(out, port, emb, q), name
    want = ref(q, k, ids=ids)
    assert [set(r) for r in out.indices] == [set(r) for r in want.indices]


def test_l2_metric_store(tmp_path):
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((300, 32)).astype(np.float32)
    q = rng.standard_normal((4, 32)).astype(np.float32)
    port, ref = _pair(tmp_path, emb, metric="l2")
    out = port(q, 5)
    d2 = ((q[:, None, :] - emb[None, :, :]) ** 2).sum(-1)
    want = np.argsort(d2, axis=1)[:, :5]
    assert (np.asarray(out.indices) == want).mean() > 0.99
    np.testing.assert_allclose(np.asarray(out.distances), np.take_along_axis(d2, want, 1), rtol=1e-3, atol=1e-3)
    assert out.indices == ref(q, 5).indices


def test_k_exceeds_n_pads_with_minus_one(tmp_path):
    emb = np.random.default_rng(1).standard_normal((6, 16)).astype(np.float32)
    port, ref = _pair(tmp_path, emb)
    idx = np.asarray(port(emb[:2], 10).indices)
    assert idx.shape == (2, 10) and (idx[:, 6:] == -1).all()
    assert idx.tolist() == ref(emb[:2], 10).indices


def test_flat_reload_from_disk(tmp_path, data):
    emb, queries = data
    port, ref = _pair(tmp_path, emb)
    vs2 = TorchVS(device="cpu")
    vs2.load_index(port.index_dir)
    out = vs2(queries[:2], 5)
    assert (np.asarray(out.indices) == brute_topk(emb, queries[:2], 5)).all()
    assert out.indices == ref(queries[:2], 5).indices


def test_get_vectors_from_index(tmp_path, data):
    emb, _ = data
    port, ref = _pair(tmp_path, emb)
    got = port.get_vectors_from_index(port.index_dir, [3, 11, 42])
    np.testing.assert_allclose(got, emb[[3, 11, 42]], rtol=1e-6)
    np.testing.assert_array_equal(got, ref.get_vectors_from_index(port.index_dir, [3, 11, 42]))


def test_flat_scan_pallas_forced_matches_xla(tmp_path):
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((2048, 32)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = emb[:8] + 0.01 * rng.standard_normal((8, 32)).astype(np.float32)
    port, ref = _pair(tmp_path, emb, index_type="flat", metric="ip", device_dtype="bfloat16", block_rows=1024,
                      scan="pallas")  # K2's plain version on the CPU
    default = TorchVS(index_type="flat", device_dtype="bfloat16", block_rows=1024, device="cpu")
    default.load_index(port.index_dir)
    out = port(q, 5)
    assert _recall(out.indices, np.asarray(default(q, 5).indices), 5) >= 0.9
    assert [set(r) for r in out.indices] == [set(r) for r in ref(q, 5).indices]


def test_planner_routes_small_batch_to_the_grouped_probe_when_eligible(tmp_path):
    """Block-aligned stores serve every batch size through the grouped probe,
    unless calibration dropped that regime: then the window probe."""
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((2048, 64)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    queries = emb[:2] + 0.02 * rng.standard_normal((2, 64)).astype(np.float32)
    port, ref = _pair(tmp_path, emb, index_type="ivf", nlist=4, nprobe=1)  # 512 rows a list
    assert port._pallas_eligible(port._materialize()["meta"])
    seen: list[bool] = []
    orig = port._probe_ivf

    def spy(state, xq, k, nprobe, *, use_pallas, **kw):
        seen.append(use_pallas)
        return orig(state, xq, k, nprobe, use_pallas=use_pallas, **kw)

    port._probe_ivf = spy
    for dropped, route in ((set(), True), ({"pallas"}, False)):
        port._regimes_dropped = ref._regimes_dropped = dropped
        seen.clear()
        out = port(queries[:1], 5)  # 1 * 1 < 4
        assert seen == [route]
        assert set(out.indices[0]) == set(ref(queries[:1], 5).indices[0])


def test_ivf_residual_spill_clustered(tmp_path):
    """Residual int8 + boundary spill on clustered data, through the port's
    ops (``build_ivf`` on the CPU, ``load_ivf_state``, ``ivf_search``)."""
    from lotus_tpu.ops import ivf as jivf
    from lotus_tpu_torch.ops import io as index_io
    from lotus_tpu_torch.ops.ivf import build_ivf, ivf_search, load_ivf_state

    import jax.numpy as jnp

    emb, queries = _clustered(11, 4000, c=24)
    queries = np.concatenate([queries, queries[:8]])
    d = str(tmp_path / "ix")
    meta = build_ivf(d, emb, nlist=24, metric="ip", block_align=512, spill_frac=0.2, device="cpu")
    index_io.write_meta(d, {**meta, "metric": "ip", "encoding": "residual_int8"})
    meta_full = index_io.read_meta(d)
    state = load_ivf_state(d, meta_full, torch.int8, device="cpu")
    state.setdefault("meta", meta_full)
    assert state["meta"].get("encoding") == "residual_int8"  # no plain-int8 fallback
    rid = state["ivf_row_ids"].numpy()
    counts = np.bincount(rid[rid >= 0], minlength=4000)
    assert counts.min() >= 1 and counts.max() == 2 and (counts == 2).sum() > 0

    _, idx = ivf_search(state, torch.from_numpy(queries), 5, nprobe=24, metric="ip")
    got = idx.numpy()
    for row in got:
        ids = [v for v in row if v >= 0]
        assert len(ids) == len(set(ids))
    gt = np.argsort(-(queries @ emb.T), axis=1)[:, :5]
    assert _recall(got, gt, 5) >= 0.95
    js = jivf.load_ivf_state(d, meta_full, jnp.int8)
    js.setdefault("meta", meta_full)
    _, want = jivf.ivf_search(js, jnp.asarray(queries), 5, nprobe=24, metric="ip")
    assert [set(r) for r in got.tolist()] == [set(r) for r in np.asarray(want).tolist()]


def test_int8_refine_rescore(tmp_path):
    """int8 + int4 refinement + exact rescoring, one query per call: the
    window probe with rescoring."""
    emb, queries = _clustered(7, 3000)
    port, ref = _pair(tmp_path, emb, index_type="ivf", nlist=32, nprobe=16, device_dtype="int8",
                      int8_refine=True, rescore=24)
    got = np.stack([np.asarray(port(queries[r : r + 1], 5).indices)[0] for r in range(16)])
    assert _recall(got, np.argsort(-(queries @ emb.T), axis=1)[:, :5], 5) >= 0.97
    assert "ivf_refine" in port._state and port.stats["routes"]["window_probe"] == 16
    want = [ref(queries[r : r + 1], 5).indices[0] for r in range(16)]
    assert [set(r) for r in got.tolist()] == [set(r) for r in want]


def test_scan_knob_validation():
    with pytest.raises(ValueError, match="scan"):
        TorchVS(scan="fused", device="cpu")


def test_grouped_probe_knob_plumbing(tmp_path, monkeypatch):
    """TorchVS forwards query_chunk and resolves int8_queries=None (auto) to
    False on an f32 store: the grouped probe sees the knobs."""
    from lotus_tpu_torch.ops import ivf_probe

    rng = np.random.default_rng(11)
    emb = rng.standard_normal((8192, 32)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    queries = emb[:64] + 0.01 * rng.standard_normal((64, 32)).astype(np.float32)
    vs = TorchVS(index_type="ivf", metric="ip", nlist=8, nprobe=4, query_chunk=16, device="cpu")
    vs.index([str(i) for i in range(len(emb))], emb, str(tmp_path / "plumb"))
    seen = {}
    real = ivf_probe.ivf_search_grouped_probe

    def spy(state, xq, k, **kw):
        seen.update(kw)
        return real(state, xq, k, **kw)

    monkeypatch.setattr(ivf_probe, "ivf_search_grouped_probe", spy)
    vs(queries, 5)
    assert seen.get("query_chunk") == 16
    assert seen.get("int8_queries") is False


def test_store_stats_accumulate(tmp_path, data):
    emb, queries = data
    port, _ = _pair(tmp_path, emb, index_type="flat", metric="ip")
    port(queries[:4], 3)
    after_one = {k: v for k, v in port.stats.items() if k != "routes"}
    port(queries, 3)
    assert port.stats["searches"] == after_one["searches"] + 1
    assert port.stats["queries"] == after_one["queries"] + len(queries)
    assert port.stats["total_wall_s"] > after_one["total_wall_s"] > 0.0
    assert port.stats["routes"]["scan"] == 2


# --------------------------------------------------------------- operators
_TITLES = [
    "Machine learning tutorial", "Deep learning with neural networks", "Cooking pasta at home",
    "Best pasta recipes", "Quantum computing basics", "Intro to machine learning",
]


def _df(tmp_path):
    return pd.DataFrame({"title": _TITLES}).sem_index("title", str(tmp_path / "title_idx"))


def _sem_index_records_dir(tmp_path):
    df = _df(tmp_path)
    assert "title" in df.attrs["index_dirs"]
    return sorted(df.attrs["index_dirs"])


def _sem_search_returns_relevant(tmp_path):
    out = _df(tmp_path).sem_search("title", "machine learning", K=2)
    assert len(out) == 2 and all("learning" in t.lower() for t in out["title"])
    return list(out.index)


def _sem_search_respects_filtered_df(tmp_path):
    df = _df(tmp_path)
    sub = df[df.index >= 2]
    out = sub.sem_search("title", "machine learning", K=2)
    assert len(out) == 2 and set(out.index) <= set(sub.index)
    return list(out.index)


def _sem_search_with_scores(tmp_path):
    out = _df(tmp_path).sem_search("title", "pasta recipes", K=3, return_scores=True)
    scores = out["vec_scores_sim_score"].to_numpy()
    assert (np.diff(scores) <= 1e-6).all()
    return list(out.index), np.round(scores, 5).tolist()


def _load_sem_index_resumes(tmp_path):
    df = _df(tmp_path)
    fresh = pd.DataFrame({"title": df["title"]}).load_sem_index("title", str(tmp_path / "title_idx"))
    out = fresh.sem_search("title", "quantum computing", K=1)
    assert out["title"].iloc[0] == "Quantum computing basics"
    return list(out.index)


def _sem_sim_join(tmp_path):
    left = pd.DataFrame({"query": ["pasta dishes", "neural nets"]})
    joined = left.sem_sim_join(_df(tmp_path), left_on="query", right_on="title", K=2)
    assert len(joined) == 4 and "_scores" in joined.columns
    assert any("pasta" in t.lower() for t in joined[joined["query"] == "pasta dishes"]["title"])
    return sorted(map(tuple, joined[["query", "title"]].values))


def _partition(labels):
    """Cluster labels up to relabelling: each label replaced by the order of
    its first row."""
    first: dict = {}
    return [first.setdefault(x, len(first)) for x in labels]


def _sem_cluster_by(tmp_path):
    out = _df(tmp_path).sem_cluster_by("title", 2, niter=10)
    assert "cluster_id" in out.columns and out["cluster_id"].nunique() == 2
    return _partition(out["cluster_id"])


def _dup_components(df, threshold):
    """Brute-force duplicate components of ``df["text"]`` over the embeddings
    the store searched: union-find over the thresholded similarity matrix,
    identical texts always merged."""
    emb = np.asarray(lotus_tpu.settings.rm(df["text"].tolist()))
    emb = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    sims = emb @ emb.T
    n = len(df)
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i in range(n):
        for j in range(i + 1, n):
            if sims[i, j] > threshold or df["text"].iloc[i] == df["text"].iloc[j]:
                parent[find(i)] = find(j)
    comp_of: dict[int, set] = {}
    for i in range(n):
        comp_of.setdefault(find(i), set()).add(df["text"].iloc[i])
    return list(comp_of.values())


def _kept_components(out, components):
    """The components the kept rows stand for, one entry per kept row.
    ``sem_dedup`` keeps the first value of each component in the iteration
    order of a Python set of string pairs, which follows the process's hash
    seed, so which member stands for a component is not a property of the
    store: ``TpuVS`` itself keeps different members in different processes
    whenever a component holds texts with equal embeddings ("t" and "t!")."""
    return sorted(tuple(sorted(c)) for t in out["text"] for c in components if t in c)


def _sem_dedup(tmp_path):
    df = pd.DataFrame({"text": [
        "the quick brown fox jumps", "the quick brown fox jumps!",
        "a completely different sentence about databases", "the quick brown fox jumped",
    ]}).sem_index("text", str(tmp_path / "dedup_idx"))
    out = df.sem_dedup("text", threshold=0.85)
    assert len(out) < 4 and "a completely different sentence about databases" in out["text"].tolist()
    return _kept_components(out, _dup_components(df, 0.85))


def _sem_partition_by(tmp_path):
    out = _df(tmp_path).sem_partition_by(lotus_tpu.utils.cluster("title", 2))
    assert "_lotus_partition_id" in out.columns
    return _partition(out["_lotus_partition_id"])


def _sem_search_rerank_with_fake_reranker(tmp_path):
    from lotus_tpu.models.reranker import Reranker
    from lotus_tpu.types import RerankerOutput

    class ReverseReranker(Reranker):
        def __call__(self, query, docs, K):
            return RerankerOutput(indices=list(range(len(docs)))[::-1][:K])

    df = _df(tmp_path)
    lotus_tpu.settings.configure(reranker=ReverseReranker())
    plain = df.sem_search("title", "machine learning", K=3)
    reranked = df.sem_search("title", "machine learning", K=3, n_rerank=2)
    assert len(reranked) == 2 and reranked["title"].iloc[0] == plain["title"].iloc[2]
    return list(reranked.index)


def _sem_dedup_exact_mode_matches_bruteforce_oracle(tmp_path):
    rng = np.random.default_rng(77)
    base = [
        "the quick brown fox jumps over the lazy dog", "a database transaction commits atomically",
        "stars form inside collapsing molecular clouds", "fresh basil elevates a simple tomato sauce",
        "gradient descent minimizes the training loss",
    ]
    texts = [v for t in base for v in (t, t + "!", "note: " + t)]
    rng.shuffle(texts)
    df = pd.DataFrame({"text": texts}).sem_index("text", str(tmp_path / "exact_idx"))
    out = df.sem_dedup("text", threshold=0.8, max_neighbors=None)
    components = _dup_components(df, 0.8)
    kept = set(out["text"])
    assert all(len(kept & members) == 1 for members in components)
    assert len(out) == len(components)
    return _kept_components(out, components)


def _sem_search_empty_filtered_df(tmp_path):
    df = _df(tmp_path)
    out = df[df["title"] == "no such row"].sem_search("title", "anything", K=2)
    assert len(out) == 0
    return len(out)


OPERATOR_SCENARIOS = {fn.__name__.lstrip("_"): fn for fn in (
    _sem_index_records_dir, _sem_search_returns_relevant, _sem_search_respects_filtered_df,
    _sem_search_with_scores, _load_sem_index_resumes, _sem_sim_join, _sem_cluster_by, _sem_dedup,
    _sem_partition_by, _sem_search_rerank_with_fake_reranker, _sem_dedup_exact_mode_matches_bruteforce_oracle,
    _sem_search_empty_filtered_df,
)}


def _no_jax_kmeans(*args, **kwargs):
    raise AssertionError("the port's store ran JAX's k-means")


@pytest.mark.parametrize("name", sorted(OPERATOR_SCENARIOS))
def test_operator_scenario_matches_reference(tmp_path, monkeypatch, name):
    results = {}
    for tag, vs in (("ref", TpuVS()), ("port", TorchVS(device="cpu"))):
        lotus_tpu.settings.configure(rm=HashRM(dim=48), vs=vs, lm=None, enable_cache=False)
        try:
            (tmp_path / tag).mkdir()
            with monkeypatch.context() as m:
                if tag == "port":  # the port's cluster(), as the README selects it
                    m.setattr(lotus_tpu.utils, "cluster", bind_cluster(vs))
                    m.setattr(lotus_tpu.ops.kmeans, "kmeans_fit", _no_jax_kmeans)
                results[tag] = OPERATOR_SCENARIOS[name](tmp_path / tag)
        finally:
            lotus_tpu.settings.configure(rm=None, vs=None, reranker=None)
    assert results["port"] == results["ref"]
