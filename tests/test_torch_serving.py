"""``lotus_tpu.serving`` over the port's store: the reference's serving
tier serves ``TorchVS`` through ``vs_search_fn`` (``serving/__init__.py:
64-78``) where both packages are installed.  A ``ShardServer`` around the
port's store and a ``SearchFrontEnd`` over two port shards must give
``TpuVS``'s rows, the latter with global ids.  The port's own serving tier
(``lotus_tpu_torch.serving``) is held to the reference's in
``test_torch_serving_port.py``."""

import numpy as np
import pytest

from lotus_tpu.serving import SearchFrontEnd, ShardClient, ShardServer, vs_search_fn
from lotus_tpu.vector_store import TpuVS
from lotus_tpu_torch import TorchVS

RNG = np.random.default_rng(11)
N, D, K = 600, 16, 10
CORPUS = RNG.standard_normal((N, D)).astype(np.float32)
CORPUS /= np.linalg.norm(CORPUS, axis=1, keepdims=True)
QUERIES = CORPUS[:6] + 0.05 * RNG.standard_normal((6, D)).astype(np.float32)

STORES = {"flat": dict(index_type="flat"), "ivf": dict(index_type="ivf", nlist=4, nprobe=4)}


def _store(cls, path, rows, kw):
    vs = cls(**kw, **({"device": "cpu"} if cls is TorchVS else {}))
    vs.index([str(i) for i in range(rows.shape[0])], rows, str(path))
    return vs


@pytest.mark.parametrize("kind", sorted(STORES))
def test_shard_server_gives_tpuvs_rows(tmp_path, kind):
    want = _store(TpuVS, tmp_path / "ref", CORPUS, STORES[kind])(QUERIES, K)
    server = ShardServer(vs_search_fn(_store(TorchVS, tmp_path / "port", CORPUS, STORES[kind]))).start()
    try:
        client = ShardClient(server.address)
        dists, ids = client.search(QUERIES, K)
        client.close()
    finally:
        server.stop()
    np.testing.assert_array_equal(ids, np.asarray(want.indices))
    np.testing.assert_allclose(dists, np.asarray(want.distances), atol=1e-5)


@pytest.mark.parametrize("kind", sorted(STORES))
def test_front_end_over_two_port_shards(tmp_path, kind):
    half = N // 2
    servers = [ShardServer(vs_search_fn(_store(TorchVS, tmp_path / f"s{i}", rows, STORES[kind]), id_offset=off)).start()
               for i, (rows, off) in enumerate(((CORPUS[:half], 0), (CORPUS[half:], half)))]
    ref = [vs_search_fn(_store(TpuVS, tmp_path / f"r{i}", rows, STORES[kind]), id_offset=off)
           for i, (rows, off) in enumerate(((CORPUS[:half], 0), (CORPUS[half:], half)))]
    try:
        with SearchFrontEnd([s.address for s in servers]) as fe:
            dists, ids = fe.search(QUERIES, K)
    finally:
        for s in servers:
            s.stop()
    # The reference's rows: each TpuVS shard's top-k in global ids, merged.
    parts = [fn(QUERIES, K) for fn in ref]
    scores = np.concatenate([p[0] for p in parts], axis=1)
    order = np.argsort(-scores, axis=1, kind="stable")[:, :K]
    want_ids = np.take_along_axis(np.concatenate([p[1] for p in parts], axis=1), order, axis=1)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(dists, np.take_along_axis(scores, order, axis=1), atol=1e-5)
    assert ids.min() >= 0 and ids.max() < N and (ids[:, 0] == np.arange(6)).all()
