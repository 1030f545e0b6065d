"""Recall-target calibration in the port: ``lotus_tpu_torch.ops.autotune``
and ``TorchVS.calibrate_nprobe``, mirroring every case of
``tests/test_autotune.py`` except the sharded store (in
``test_torch_parallel.py``, on four gloo ranks), plus
calibrations that one package persists and the other adopts.

Tolerance: the pure functions return exactly the reference's dicts; the
store-level cases hold the same recall bars as the reference's tests, and a
calibration measured by both packages on one window-regime store picks the
same nprobe with recalls within 0.02 (the two window probes agree on sets
except at near-ties).
"""

import json
import logging
import os
import unittest.mock as mock

import numpy as np
import pytest

from lotus_tpu.ops import autotune as jautotune
from lotus_tpu.vector_store import TpuVS
from lotus_tpu_torch import TorchVS
from lotus_tpu_torch.ops import autotune


def _store(**kw):
    return TorchVS(device="cpu", **kw)


def _clustered_emb(seed, n, d, c, spread):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((c, d)).astype(np.float32)
    emb = centers[rng.integers(0, c, n)] + spread * rng.standard_normal((n, d)).astype(np.float32)
    return emb / np.linalg.norm(emb, axis=1, keepdims=True)


def test_nprobe_ladder_shape():
    lad = autotune.nprobe_ladder(64)
    assert lad[0] == 1 and lad[-1] == 64
    assert all(b > a for a, b in zip(lad, lad[1:]))
    assert all(b <= 2 * a for a, b in zip(lad, lad[1:]))  # ~1.5x steps
    for nlist, start in ((64, 1), (4096, 1), (7, 3), (1, 1)):
        assert autotune.nprobe_ladder(nlist, start) == jautotune.nprobe_ladder(nlist, start)


def test_recall_at_k_ignores_padding():
    got = np.array([[1, 2, -1], [7, 8, 9]])
    want = np.array([[1, 3, -1], [7, 8, 9]])
    # Normalized by the VALID oracle ids, not k.
    assert autotune.recall_at_k(got, want, 3) == pytest.approx((1 / 2 + 1.0) / 2)
    assert autotune.recall_at_k(got, want, 3) == jautotune.recall_at_k(got, want, 3)


def test_recall_at_k_reaches_one_with_padded_oracle():
    got = np.array([[4, 9, -1, -1]])
    want = np.array([[9, 4, -1, -1]])
    assert autotune.recall_at_k(got, want, 4) == 1.0


def test_calibrate_picks_smallest_sufficient_nprobe():
    want = np.tile(np.arange(10), (4, 1))

    def search_fn(xq, k, nprobe):  # nprobe p reveals the first p true ids
        out = np.full((4, k), -1)
        out[:, : min(nprobe, k)] = want[:, : min(nprobe, k)]
        return out

    args = (search_fn, np.zeros((4, 8), np.float32))
    res = autotune.calibrate_nprobe(*args, nlist=64, recall_target=0.55, k=10)
    assert res["nprobe"] == 6  # ladder 1,2,3,4,6: the first with recall 0.6
    assert res["recall"] == pytest.approx(0.6)
    assert res["ladder"][-1][0] == 6
    assert res == jautotune.calibrate_nprobe(*args, nlist=64, recall_target=0.55, k=10)


def test_calibrate_falls_back_to_full_probe():
    def search_fn(xq, k, nprobe):
        if nprobe >= 64:  # only the full probe finds anything
            return np.tile(np.arange(k), (2, 1))
        return np.full((2, k), -1)

    res = autotune.calibrate_nprobe(search_fn, np.zeros((2, 8), np.float32), nlist=64, recall_target=0.99, k=5)
    assert res["nprobe"] == 64
    assert res["recall"] == 1.0


@pytest.fixture
def clustered(tmp_path):
    emb = _clustered_emb(5, 3000, 48, 16, 0.15)
    d = str(tmp_path / "ivf")
    vs = _store(index_type="ivf", nlist=16, nprobe=1)
    vs.index([], emb, d)
    return vs, emb, d


def test_torch_vs_calibrate_and_persist(clustered):
    vs, emb, d = clustered
    res = vs.calibrate_nprobe(0.95, k=10, nq=64)
    assert 1 <= res["nprobe"] < 16  # on clustered data a partial probe suffices
    assert res["recall"] >= 0.95
    assert res["regimes"] == ["window"]  # 3000 rows in 16 lists: unaligned
    assert vs.nprobe == res["nprobe"]
    with open(os.path.join(d, "meta.json")) as f:
        assert json.load(f)["calibration"]["0.95@10"]["nprobe"] == res["nprobe"]
    # The calibrated store delivers the target on perturbed queries.
    rng = np.random.default_rng(7)
    q = emb[rng.integers(0, len(emb), 32)] + 0.02 * rng.standard_normal((32, 48)).astype(np.float32)
    got = np.asarray(vs(q, 10).indices)
    ref = np.argsort(-(q @ emb.T), axis=1)[:, :10]
    assert np.mean([len(set(got[i]) & set(ref[i])) / 10 for i in range(32)]) >= 0.9


def test_recall_target_reuses_persisted_calibration(clustered, monkeypatch):
    vs, emb, d = clustered
    first = vs.calibrate_nprobe(0.95, k=10, nq=64)

    def boom(*a, **kw):  # pragma: no cover - failure path
        raise AssertionError("calibration should have been reused from meta.json")

    monkeypatch.setattr(autotune, "calibrate_nprobe", boom)
    vs2 = _store(index_type="ivf", nlist=16, recall_target=0.95)
    vs2.load_index(d)
    out = vs2(emb[:4], 10)
    assert np.asarray(out.indices).shape == (4, 10)
    assert vs2.nprobe == first["nprobe"]


def test_exact_oracle_calibration_on_quantized_store(tmp_path):
    """oracle='exact' makes recall_target absolute: on an int8 store either
    the target is met against f32 ground truth or flagged unreachable."""
    emb = _clustered_emb(11, 4000, 64, 8, 0.02)  # tight clusters: near-ties at the boundary
    d = str(tmp_path / "q")
    vs = _store(index_type="ivf", nlist=8, device_dtype="int8", int8_encoding="plain")
    vs.index([], emb, d)

    rel = vs.calibrate_nprobe(0.999, k=10, nq=64)
    assert rel["oracle"] == "full_probe"
    assert rel["recall_abs"] is None and rel["ceiling"] == 1.0

    res = vs.calibrate_nprobe(0.999, k=10, nq=64, oracle="exact")
    assert res["oracle"] == "exact" and res["recall_abs"] is not None
    assert res["ceiling"] < 1.0  # quantization: even the full probe is imperfect
    if res["target_unreachable"]:
        assert res["ceiling"] < 0.999 and res["nprobe"] == 8
    else:
        assert res["recall"] >= 0.999
    with open(os.path.join(d, "meta.json")) as f:
        cal = json.load(f)["calibration"]
    assert "0.999@10" in cal and "0.999@10/exact" in cal
    # The absolute number is honest against an independent exact scan.
    got = np.asarray(vs(emb[:64], 10, nprobe=res["nprobe"]).indices)
    ref = np.argsort(-(emb[:64] @ emb.T), axis=1)[:, :10]
    assert np.mean([len(set(got[i]) & set(ref[i])) / 10 for i in range(64)]) >= res["recall"] - 0.05


def test_exact_topk_matches_numpy(tmp_path):
    """The exact oracle (chunked, on the store's device) equals a numpy scan."""
    emb = _clustered_emb(3, 3000, 32, 8, 0.3)
    rng = np.random.default_rng(4)
    q = emb[:20] + 0.05 * rng.standard_normal((20, 32)).astype(np.float32)
    for metric in ("ip", "l2"):
        vs = _store(index_type="ivf", nlist=8, metric=metric)
        vs.index([], emb, str(tmp_path / metric))
        got = vs._exact_topk(q, 10, metric)
        s = q @ emb.T if metric == "ip" else 2 * q @ emb.T - (emb * emb).sum(1)[None, :]
        np.testing.assert_array_equal(got, np.argsort(-s, axis=1)[:, :10])


def test_calibrate_measures_the_served_regime_only(tmp_path):
    """A block-aligned store serves every batch through the grouped probe,
    so calibration measures only that path; an unaligned one the window."""
    emb = _clustered_emb(2, 4096, 32, 4, 0.1)
    vs = _store(index_type="ivf", nlist=4)
    vs.index([], emb, str(tmp_path / "blk"))
    assert vs._pallas_eligible(vs._materialize()["meta"])  # no interpret flag needed
    res = vs.calibrate_nprobe(0.9, k=10, nq=32)
    assert res["regimes"] == ["pallas"]
    assert res["recall"] >= 0.9

    vs2 = _store(index_type="ivf", nlist=64)  # 64 rows a list: unaligned
    vs2.index([], emb, str(tmp_path / "noblk"))
    assert not vs2._pallas_eligible(vs2._materialize()["meta"])
    res2 = vs2.calibrate_nprobe(0.9, k=10, nq=32)
    assert res2["regimes"] == ["window"]
    assert res2["recall"] >= 0.9


def test_lazy_autotune_warns_on_user_set_nprobe(clustered, caplog):
    vs, emb, d = clustered
    vs.calibrate_nprobe(0.95, k=10, nq=64)  # persist an entry
    vs2 = _store(index_type="ivf", nlist=16, nprobe=3, recall_target=0.95)
    vs2.load_index(d)
    with caplog.at_level(logging.WARNING, logger="lotus_tpu_torch"):
        vs2(emb[:4], 10)
    if vs2.nprobe != 3:  # calibration picked a different point
        assert any("overriding explicitly constructed" in r.message for r in caplog.records)


def test_lazy_autotune_calibrates_once_across_distinct_k(clustered, monkeypatch):
    vs, emb, d = clustered
    calls = {"n": 0}
    real = autotune.calibrate_nprobe

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(autotune, "calibrate_nprobe", counting)
    vs2 = _store(index_type="ivf", nlist=16, recall_target=0.95)
    vs2.load_index(d)
    for k in (5, 20, 7):
        vs2(emb[:4], k)
    assert calls["n"] == 1  # no persisted entry: one calibration, never per K


def test_calibrate_requires_ivf(tmp_path):
    vs = _store()
    vs.index([], np.eye(8, 32, dtype=np.float32), str(tmp_path / "flat"))
    with pytest.raises(ValueError, match="IVF"):
        vs.calibrate_nprobe(0.9)


def test_multi_regime_fallback_reports_worst_regime_and_unreachable():
    truth = np.random.default_rng(5).integers(0, 1000, size=(32, 10)).astype(np.int64)

    def window_fn(xq, k, nprobe):  # disagrees with the anchor on 3 of 10 ids
        out = truth.copy()
        out[:, :3] = truth[:, :3] + 100000
        return out

    res = autotune.calibrate_nprobe(
        {"pallas": lambda xq, k, nprobe: truth, "window": window_fn}, np.zeros((32, 8), np.float32),
        nlist=64, recall_target=0.95, k=10, oracle_regime="pallas",
    )
    assert res["nprobe"] == 64 and res["target_unreachable"] is True
    assert res["recall"] == pytest.approx(0.7, abs=0.02)
    assert res["ceiling"] == pytest.approx(0.7, abs=0.02)


def _aligned_store(tmp_path, name="drop"):
    emb = _clustered_emb(9, 2048, 32, 4, 0.1)
    vs = _store(index_type="ivf", nlist=4)
    vs.index([], emb, str(tmp_path / name))
    assert vs._pallas_eligible(vs._materialize()["meta"])
    return vs, emb


def _corrupting(regimes):
    """A stand-in for autotune.calibrate_nprobe that drops half the hits of
    the named regimes (the grouped probe's candidate caps on a degenerate
    corpus, cheaply)."""
    real = autotune.calibrate_nprobe

    def wrapped(fns, xq, **kw):
        def bad(inner):
            def fn(q, k, nprobe):
                out = np.asarray(inner(q, k, nprobe)).copy()
                out[:, : max(1, out.shape[1] // 2)] = -1
                return out
            return fn

        return real({name: bad(fn) if name in regimes else fn for name, fn in fns.items()}, xq, **kw)

    return wrapped


def test_calibration_drops_regime_that_cannot_reach_target(tmp_path):
    """When the grouped probe's ceiling misses the target and the window
    probe's does not, calibration drops "pallas" and __call__ routes around
    it: large batches to the exhaustive scan, small ones to the window."""
    vs, emb = _aligned_store(tmp_path)
    with mock.patch.object(autotune, "calibrate_nprobe", side_effect=_corrupting({"pallas"})):
        res = vs.calibrate_nprobe(0.9, k=10, nq=32, oracle="exact")
    assert res["regimes_dropped"] == ["pallas"]
    assert res["regimes"] == ["window"]
    assert res["recall"] >= 0.9
    assert vs._regimes_dropped == {"pallas"}

    out = vs(emb[:64], 10)  # 64 * nprobe >= 4: the exhaustive scan
    got = np.asarray(out.indices)
    truth = np.argsort(-(emb[:64] @ emb.T), axis=1)[:, :10]
    assert np.mean([len(set(got[i]) & set(truth[i])) / 10 for i in range(64)]) >= 0.9
    vs(emb[:1], 10, nprobe=2)  # 1 * 2 < 4: the window probe, not the dropped grouped probe
    assert vs.stats["routes"] == {"grouped_probe": 0, "window_probe": 1, "scan": 1}
    with open(os.path.join(vs.index_dir, "meta.json")) as f:
        assert json.load(f)["calibration"]["0.9@10/exact"]["regimes_dropped"] == ["pallas"]


def test_both_regimes_unreachable_keeps_the_grouped_result(tmp_path):
    """The reference's rule (``tpu_vs.py:607``), mirrored on purpose: when the
    window recalibration misses the target too, the grouped-probe result is
    kept as it is, without comparing the two ceilings."""
    vs, _ = _aligned_store(tmp_path, "both")
    with mock.patch.object(autotune, "calibrate_nprobe", side_effect=_corrupting({"pallas", "window"})):
        res = vs.calibrate_nprobe(0.9, k=10, nq=32, oracle="exact")
    assert res["target_unreachable"] and res["regimes"] == ["pallas"]
    assert "regimes_dropped" not in res and vs._regimes_dropped == set()
    assert res["nprobe"] == 4  # the full probe


def _forbid(module):
    def boom(*a, **kw):  # pragma: no cover - failure path
        raise AssertionError(f"{module.__name__} measured instead of adopting the persisted entry")

    return mock.patch.object(module, "calibrate_nprobe", side_effect=boom)


@pytest.mark.parametrize("writer", ["TpuVS", "TorchVS"])
def test_calibration_cross_loads(tmp_path, writer):
    """A calibration persisted by one package's store is adopted by the
    other's without measuring: same key, same entry, same nprobe; a dropped
    regime routes both the same way."""
    emb = _clustered_emb(5, 3000, 48, 16, 0.15)
    d = str(tmp_path / "x")
    make = {"TpuVS": lambda **kw: TpuVS(**kw), "TorchVS": lambda **kw: _store(**kw)}
    reader = "TorchVS" if writer == "TpuVS" else "TpuVS"
    first = make[writer](index_type="ivf", nlist=16)
    first.index([], emb, d)
    res = first.calibrate_nprobe(0.95, k=10, nq=64)
    with open(os.path.join(d, "meta.json")) as f:
        entry = json.load(f)["calibration"]["0.95@10"]

    second = make[reader](index_type="ivf", nlist=16, recall_target=0.95)
    second.load_index(d)
    with _forbid(autotune), _forbid(jautotune):
        out = second(emb[:4], 10)
        assert second.nprobe == res["nprobe"] == entry["nprobe"]
        assert second.calibrate_nprobe(0.95, k=10) == entry
    assert [row[0] for row in out.indices] == [0, 1, 2, 3]

    # An entry with the grouped regime dropped: both packages adopt the drop.
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    meta["calibration"]["0.9@10"] = {**entry, "recall_target": 0.9, "regimes_dropped": ["pallas"]}
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(meta, f)
    for name in ("TpuVS", "TorchVS"):
        vs = make[name](index_type="ivf", nlist=16, recall_target=0.9)
        vs.load_index(d)
        with _forbid(autotune), _forbid(jautotune):
            vs(emb[:1], 10)
        assert vs._regimes_dropped == {"pallas"} and vs.nprobe == entry["nprobe"]


def test_window_regime_calibration_matches_reference(tmp_path):
    """Both packages calibrate one unaligned store to the same nprobe, with
    recalls within 0.02 at every ladder point (exact oracle)."""
    emb = _clustered_emb(6, 3000, 48, 16, 0.3)
    d = str(tmp_path / "w")
    ref = TpuVS(index_type="ivf", nlist=24)
    ref.index([], emb, d)
    port = _store(index_type="ivf", nlist=24)
    port.load_index(d)
    r = ref.calibrate_nprobe(0.95, k=10, nq=64, oracle="exact", persist=False)
    p = port.calibrate_nprobe(0.95, k=10, nq=64, oracle="exact", persist=False)
    assert p["nprobe"] == r["nprobe"] and p["regimes"] == r["regimes"] == ["window"]
    assert [a for a, _ in p["ladder"]] == [a for a, _ in r["ladder"]]
    np.testing.assert_allclose([b for _, b in p["ladder"]], [b for _, b in r["ladder"]], atol=0.02)
    assert p["ceiling"] == pytest.approx(r["ceiling"], abs=0.02)
