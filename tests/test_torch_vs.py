"""``TorchVS`` against ``TpuVS`` (Pallas in interpret mode) on the same index
directories, and behind LOTUS's pandas operators."""

import numpy as np
import pandas as pd
import pytest

import lotus_tpu
from lotus_tpu.models import HashRM
from lotus_tpu.vector_store import TpuVS
from lotus_tpu_torch import TorchVS


def _emb(seed, n=8192, d=32, c=8):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((c, d)).astype(np.float32)
    emb = centers[rng.integers(0, c, n)] + 0.3 * rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = emb[rng.integers(0, n, 16)] + 0.02 * rng.standard_normal((16, d)).astype(np.float32)
    return emb, q, rng


def _pair(tmp_path, emb, **kw):
    idx = str(tmp_path / "idx")
    ref = TpuVS(**kw)
    ref.index([], emb, idx)
    ref._pallas_interpret = True
    port = TorchVS(device="cpu", **kw)
    port.load_index(idx)
    return ref, port


def _same_sets(a, b):
    return all(set(x) == set(y) for x, y in zip(a.indices, b.indices))


@pytest.mark.parametrize(
    "kw",
    [
        dict(index_type="ivf", nlist=8, nprobe=4),
        dict(index_type="ivf", nlist=8, nprobe=4, device_dtype="int8", int8_refine=True, rescore=24,
             int8_queries=False),
        dict(index_type="ivf", nlist=8, nprobe=8, metric="l2"),
    ],
)
def test_ivf_store_matches_reference(tmp_path, kw):
    emb, q, rng = _emb(0)
    ref, port = _pair(tmp_path, emb, **kw)
    from lotus_tpu_torch.ops.io import read_meta

    assert int(read_meta(port.index_dir)["block_align"]) == 1024  # 8192 rows / 8 lists
    r, p = ref(q, 10), port(q, 10)  # no ids: the grouped probe (K1's plain version)
    assert _same_sets(r, p)
    np.testing.assert_allclose(np.asarray(p.distances)[:, 0], np.asarray(r.distances)[:, 0], rtol=1e-4, atol=1e-4)
    ids = sorted(rng.choice(len(emb), 500, replace=False).tolist())
    r, p = ref(q, 10, ids=ids), port(q, 10, ids=ids)  # ids: the exact subset scan
    assert _same_sets(r, p)
    assert set(np.asarray(p.indices).ravel()) <= set(ids)
    assert port.stats["searches"] == 2 and port.stats["subset_searches"] == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_flat_store_matches_reference(tmp_path, dtype):
    emb, q, rng = _emb(1, n=3000)
    ref, port = _pair(tmp_path, emb, index_type="flat", device_dtype=dtype)
    r, p = ref(q, 10), port(q, 10)
    assert _same_sets(r, p)
    ids = sorted(rng.choice(len(emb), 300, replace=False).tolist())
    r, p = ref(q, 10, ids=ids), port(q, 10, ids=ids)
    assert _same_sets(r, p)
    out = port(q[:2], 4000)  # K past the collection: -1 padding
    assert np.asarray(out.indices)[:, 3000:].tolist() == [[-1] * 1000] * 2


def test_paths_not_ported_raise(tmp_path):
    """No path is left unported: a mesh (ROADMAP M11) is accepted, and a
    mesh of one rank serves on its device as one store does (the sharded
    cases are in ``test_torch_parallel.py``); an unaligned IVF store serves
    B 1 through the window probe, and ``recall_target`` is accepted."""
    from lotus_tpu_torch.parallel import ShardMesh

    one = TorchVS(mesh=ShardMesh(None, [0], 0, "cpu"))
    assert str(one.device) == "cpu" and one._mesh_devices() == 1
    assert TorchVS(index_type="ivf", recall_target=0.9, device="cpu").recall_target == 0.9
    emb, q, _ = _emb(2, n=600, d=16)
    idx = str(tmp_path / "small")
    vs = TorchVS(index_type="ivf", nlist=16, nprobe=4, device="cpu")
    vs.index([], emb, idx)  # 600 / 16 rows per list: not block-aligned
    ref_vs = TpuVS(index_type="ivf", nlist=16, nprobe=4)
    ref_vs.load_index(idx)
    out = vs(q[:1], 5)  # 1 * 4 < 16: the window probe
    assert vs.stats["routes"] == {"grouped_probe": 0, "window_probe": 1, "scan": 0}
    assert _same_sets(out, ref_vs(q[:1], 5))
    out = vs(q[:4], 5)  # 4 * 4 >= 16: the exhaustive scan serves it
    assert vs.stats["routes"]["scan"] == 1
    ref = np.argsort(-(q[:4] @ emb.T), axis=1)[:, :5]
    assert _same_sets(out, type(out)(distances=[], indices=ref.tolist()))


def test_flat_k2_gate_reads_the_padded_length(tmp_path, monkeypatch):
    """A bf16 ``approx`` Flat store of 3,000 rows with ``block_rows=1024``:
    the reference pads it to 3,072 rows (``tpu_vs.py:275``) and gates K2 on
    that length (``:783``), so both packages scan it with K2.  The top-10
    sets agree except where the reference's 10th and 11th scores lie within
    1e-3 (the bf16 sums run in another order)."""
    import lotus_tpu.ops.pallas_flat as pflat
    from lotus_tpu_torch.ops import flat_scan as tscan

    emb, _, rng = _emb(12, n=3000)
    q = emb[rng.integers(0, 3000, 256)] + 0.02 * rng.standard_normal((256, 32)).astype(np.float32)
    ref, port = _pair(tmp_path, emb, index_type="flat", device_dtype="bfloat16", approx=True, block_rows=1024)
    calls = []
    for module, name in ((pflat, "flat_search_pallas"), (tscan, "scan_fold")):
        def spy(*a, _real=getattr(module, name), _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(module, name, spy)
    r10, r11, p10 = ref(q, 10), ref(q, 11), port(q, 10)
    assert calls == ["flat_search_pallas", "flat_search_pallas", "scan_fold"]
    r11d = np.asarray(r11.distances)
    for i, (a, b) in enumerate(zip(r10.indices, p10.indices)):
        if r11d[i, 9] - r11d[i, 10] > 1e-3:
            assert set(a) == set(b), i


def _frames():
    left = pd.DataFrame({"query": ["machine learning", "pasta dinner", "quantum physics"]})
    right = pd.DataFrame({"title": [
        "Machine learning tutorial", "Deep learning with neural networks", "Cooking pasta at home",
        "Best pasta recipes", "Quantum computing basics", "Intro to machine learning",
        "Learning to cook", "Physics of quantum computers",
    ]})
    return left, right


@pytest.mark.parametrize("store", ["flat", "ivf"])
def test_pandas_operators_match_reference(tmp_path, store):
    """sem_index / sem_search / sem_sim_join return the same rows with
    TorchVS as with TpuVS (the operators pass ids: the subset scan)."""
    kw = dict(index_type=store, nlist=2) if store == "ivf" else {}
    results = {}
    for name, vs in (("ref", TpuVS(**kw)), ("port", TorchVS(device="cpu", **kw))):
        lotus_tpu.settings.configure(rm=HashRM(dim=48), vs=vs, lm=None, enable_cache=False)
        try:
            left, right = _frames()
            right = right.sem_index("title", str(tmp_path / f"{name}_idx"))
            found = right.sem_search("title", "machine learning", K=3)
            sub = right[right.index >= 2].sem_search("title", "machine learning", K=2)
            joined = left.sem_sim_join(right, left_on="query", right_on="title", K=2)
            results[name] = (list(found.index), list(sub.index), sorted(map(tuple, joined[["query", "title"]].values)))
        finally:
            lotus_tpu.settings.configure(rm=None, vs=None)
    assert results["port"] == results["ref"]
    assert set(results["port"][1]) <= {2, 3, 4, 5, 6, 7}


def test_contract_copies_match_reference():
    """The port's copies of RMOutput and the VS contract keep the originals' shape."""
    import dataclasses
    import inspect

    from lotus_tpu.types import RMOutput as JaxRMOutput
    from lotus_tpu.vector_store.vs import VS as JaxVS
    from lotus_tpu_torch import RMOutput, VS

    assert [(f.name, str(f.type)) for f in dataclasses.fields(RMOutput)] == [
        (f.name, str(f.type)) for f in dataclasses.fields(JaxRMOutput)
    ]
    assert VS.__abstractmethods__ == JaxVS.__abstractmethods__
    for name in VS.__abstractmethods__:
        assert inspect.signature(getattr(VS, name)) == inspect.signature(getattr(JaxVS, name)), name
    for name in ("index", "load_index", "__call__", "get_vectors_from_index"):
        assert list(inspect.signature(getattr(TorchVS, name)).parameters) == list(
            inspect.signature(getattr(TpuVS, name)).parameters
        ), name
    tpu_args = list(inspect.signature(TpuVS.__init__).parameters)
    assert list(inspect.signature(TorchVS.__init__).parameters)[: len(tpu_args)] == tpu_args
