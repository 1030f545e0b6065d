"""The port's serving tier (``lotus_tpu_torch.serving``) over
``TorchVS(device="cpu")`` shards, against ``lotus_tpu.serving``.

Every case of ``tests/test_serving.py`` runs here on the port's classes,
over Flat and over IVF shards (nlist 4, nprobe 4: every list probed, so
row partitioning is lossless and the merge must equal one store's answer,
ids exactly and distances within 1e-5).  The two packages' clients and
servers then talk to each other both ways, and the port's front end over
two port shards is held to the reference's front end over two ``TpuVS``
shards (ids equal, distances within 1e-5).  Every socket has a timeout of
a few seconds (``TIMEOUT``), so a hang fails one test.
"""

import socket
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from lotus_tpu import serving as ref_serving
from lotus_tpu.vector_store import TpuVS
from lotus_tpu_torch import TorchVS, native
from lotus_tpu_torch.serving import (
    MAGIC, OP_PING, OP_SEARCH, OP_STATS, SearchFrontEnd, ShardClient, ShardServer, vs_search_fn,
)

TIMEOUT = 5.0
RNG = np.random.default_rng(7)
N, D, K = 200, 16, 10
CORPUS = RNG.standard_normal((N, D)).astype(np.float32)
QUERIES = RNG.standard_normal((5, D)).astype(np.float32)
STORES = {"flat": dict(index_type="flat", metric="ip", device_dtype="float32"),
          "ivf": dict(index_type="ivf", metric="ip", nlist=4, nprobe=4)}


def _store(path, rows: np.ndarray, kind: str, cls=TorchVS):
    vs = cls(**STORES[kind], **({"device": "cpu"} if cls is TorchVS else {}))
    vs.index([f"doc{i}" for i in range(rows.shape[0])], rows, str(path))
    return vs


def _client(address, cls=ShardClient):
    return cls(address, timeout=TIMEOUT)


def _front_end(addresses):
    return SearchFrontEnd(addresses, timeout=TIMEOUT)


@pytest.fixture(scope="module", params=sorted(STORES))
def kind(request):
    return request.param


@pytest.fixture(scope="module")
def sharded(tmp_path_factory, kind):
    tmp = tmp_path_factory.mktemp(f"serving_{kind}")
    half = N // 2
    servers = [
        ShardServer(vs_search_fn(_store(tmp / "s0", CORPUS[:half], kind), id_offset=0)).start(),
        ShardServer(vs_search_fn(_store(tmp / "s1", CORPUS[half:], kind), id_offset=half)).start(),
    ]
    yield servers
    for s in servers:
        s.stop()


# ---- tests/test_serving.py's cases on the port -----------------------------


def test_topk_merge_batch_matches_per_query():
    scores = np.sort(RNG.standard_normal((4, 3, 6)).astype(np.float32), axis=-1)[..., ::-1]
    ids = RNG.integers(0, 1000, size=(4, 3, 6)).astype(np.int64)
    bs, bi = native.topk_merge_batch(scores, ids, 5)
    for q in range(4):
        s, i = native.topk_merge(scores[q], ids[q], 5)
        np.testing.assert_array_equal(bs[q], s)
        np.testing.assert_array_equal(bi[q], i)


def test_shard_roundtrip(sharded):
    client = _client(sharded[0].address)
    assert client.ping()
    dists, ids = client.search(QUERIES, K)
    assert dists.shape == (5, K) and ids.shape == (5, K)
    assert dists.dtype == np.float32 and ids.dtype == np.int64
    assert ids.min() >= 0 and ids.max() < N // 2  # shard 0 serves global ids [0, N/2)
    client.close()


def test_frontend_matches_single_store(sharded, tmp_path, kind):
    expected = _store(tmp_path / "whole", CORPUS, kind)(QUERIES, K)
    with _front_end([s.address for s in sharded]) as fe:
        dists, ids = fe.search(QUERIES, K)
    np.testing.assert_array_equal(ids, np.asarray(expected.indices))
    np.testing.assert_allclose(dists, np.asarray(expected.distances), rtol=1e-5, atol=1e-5)
    assert np.all(np.diff(dists, axis=1) <= 1e-6)  # descending


def test_frontend_k_exceeding_shard_rows(tmp_path):
    """K larger than one shard's row count: the -1 padding must not leak into
    the merged result while real candidates remain on other shards."""
    tiny, big = CORPUS[:4], CORPUS[4:64]
    servers = [
        ShardServer(vs_search_fn(_store(tmp_path / "tiny", tiny, "flat"), id_offset=0)).start(),
        ShardServer(vs_search_fn(_store(tmp_path / "big", big, "flat"), id_offset=4)).start(),
    ]
    try:
        with _front_end([s.address for s in servers]) as fe:
            dists, ids = fe.search(QUERIES[:2], 10)
        assert np.all(ids >= 0)  # 4 + 60 rows >= 10 everywhere
        whole = _store(tmp_path / "whole64", CORPUS[:64], "flat")
        np.testing.assert_array_equal(ids, np.asarray(whole(QUERIES[:2], 10).indices))
    finally:
        for s in servers:
            s.stop()


def test_error_frame_propagates():
    def broken(xq, k):
        raise RuntimeError("index not loaded")

    server = ShardServer(broken).start()
    try:
        client = _client(server.address)
        with pytest.raises(RuntimeError, match="index not loaded"):
            client.search(QUERIES, K)
        assert client.ping()  # the connection survives an error frame
        client.close()
    finally:
        server.stop()


def test_concurrent_clients(sharded):
    """Several clients hammer one shard concurrently; each connection's
    thread answers correctly (the protocol is stateless)."""

    def one(i):
        c = _client(sharded[0].address)
        try:
            return c.search(QUERIES[i % len(QUERIES)][None, :], 3)[1][0].tolist()
        finally:
            c.close()

    with ThreadPoolExecutor(max_workers=6) as pool:
        results = list(pool.map(one, range(12)))
    for i in range(12):
        assert results[i] == results[i % len(QUERIES)]


def test_client_reuses_connection(sharded):
    client = _client(sharded[0].address)
    first = client.search(QUERIES, 3)
    second = client.search(QUERIES, 3)
    np.testing.assert_array_equal(first[1], second[1])
    assert client._conn is not None  # one persistent socket, two requests
    client.close()


def test_stats_op(sharded):
    client = _client(sharded[0].address)
    before = client.stats()
    client.search(QUERIES, 3)
    after = client.stats()
    assert set(after) == {"searches", "queries"}  # the reference's two counters
    assert after["searches"] == before["searches"] + 1
    assert after["queries"] == before["queries"] + len(QUERIES)
    client.close()


def test_frontend_stats_aggregation(sharded):
    with _front_end([s.address for s in sharded]) as fe:
        before = fe.stats()
        fe.search(QUERIES, 3)
        after = fe.stats()
    assert after["searches"] == before["searches"] + len(sharded)  # one per shard
    assert after["queries"] == before["queries"] + len(QUERIES) * len(sharded)
    assert len(after["shards"]) == len(sharded)


def test_client_reconnects_after_stale_connection(sharded):
    """A persistent connection killed underneath the client is re-established:
    each request is a self-contained frame, so one resend is safe."""
    client = _client(sharded[0].address)
    d1, i1 = client.search(QUERIES, K)
    assert client._conn is not None
    client._conn.close()
    d2, i2 = client.search(QUERIES, K)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-6)
    client.close()


def test_frontend_partial_serving_on_shard_death(sharded, tmp_path, kind):
    """A dead shard raises by default; allow_partial=True serves the live
    shards' merge and records the casualty."""
    half = N // 2
    doomed_vs = _store(tmp_path / "doomed", CORPUS[half:], kind)
    doomed = ShardServer(vs_search_fn(doomed_vs, id_offset=half)).start()
    doomed_addr = doomed.address
    fe = _front_end([sharded[0].address, doomed_addr])
    full_d, full_i = fe.search(QUERIES, K)
    assert fe.last_failed_shards == []

    doomed.stop()
    with pytest.raises(Exception):
        fe.search(QUERIES, K)
    assert fe.last_failed_shards == []  # reset up front, not stale

    d, i = fe.search(QUERIES, K, allow_partial=True)
    assert fe.last_failed_shards == [doomed_addr]
    assert (i < half).all()  # only shard-0 rows can appear now
    for row_full, row_part in zip(full_i, i):
        live = [x for x in row_full if x < half]
        assert list(row_part[: len(live)])[: K // 2] == live[: K // 2]

    fe2 = _front_end([doomed_addr])
    with pytest.raises(RuntimeError, match="all 1 shards failed"):
        fe2.search(QUERIES, K, allow_partial=True)
    fe.close()
    fe2.close()


def test_stop_kills_established_connections(tmp_path):
    """stop() terminates persistent connections, not just the listener."""
    server = ShardServer(vs_search_fn(_store(tmp_path / "est", CORPUS[:32], "flat"), id_offset=0)).start()
    client = _client(server.address)
    client.search(QUERIES, 3)
    server.stop()
    with pytest.raises((ConnectionError, OSError, RuntimeError)):
        client.search(QUERIES, 3)
    client.close()


def test_stop_during_inflight_request():
    """A request in flight when stop() lands fails at the client, and stop()
    returns (it cannot hang on the busy connection)."""
    entered = threading.Event()

    def slow_search(xq, k):
        entered.set()
        time.sleep(0.5)  # still on the device while stop() arrives
        return np.zeros((xq.shape[0], k), np.float32), np.zeros((xq.shape[0], k), np.int64)

    server = ShardServer(slow_search).start()
    client = _client(server.address)
    errors: list[BaseException] = []

    def call():
        try:
            client.search(QUERIES, 3)
        except BaseException as e:  # noqa: BLE001 - recorded for the assert
            errors.append(e)

    t = threading.Thread(target=call)
    t.start()
    assert entered.wait(timeout=TIMEOUT)
    t0 = time.monotonic()
    server.stop()
    assert time.monotonic() - t0 < 5
    t.join(timeout=10)
    assert not t.is_alive()
    assert errors, "an in-flight request must fail once the shard is stopped"
    client.close()


def test_front_end_needs_an_address():
    with pytest.raises(ValueError, match="at least one"):
        SearchFrontEnd([])


# ---- the wire, byte for byte, and the two packages on it -------------------


def _raw(address, frame: bytes, reply: int) -> bytes:
    with socket.create_connection(address, timeout=TIMEOUT) as conn:
        conn.sendall(frame)
        buf = b""
        while len(buf) < reply:
            part = conn.recv(reply - len(buf))
            if not part:
                break
            buf += part
    return buf


def test_wire_frames_by_hand(sharded):
    """The frames of the module docstring, built and parsed with struct."""
    addr = sharded[0].address
    assert _raw(addr, MAGIC + bytes([OP_PING]), 1) == b"\x00"
    q = QUERIES[:2]
    reply = _raw(addr, MAGIC + bytes([OP_SEARCH]) + struct.pack("<III", 2, D, 3) + q.astype("<f4").tobytes(),
                 1 + 8 + 2 * 3 * 12)
    assert reply[0] == 0 and struct.unpack("<II", reply[1:9]) == (2, 3)
    dists = np.frombuffer(reply[9 : 9 + 24], "<f4").reshape(2, 3)
    ids = np.frombuffer(reply[33:], "<i8").reshape(2, 3)
    want_d, want_i = _client(addr).search(q, 3)
    np.testing.assert_array_equal(ids, want_i)
    np.testing.assert_array_equal(dists, want_d)
    stats = _raw(addr, MAGIC + bytes([OP_STATS]), 5)
    assert stats[0] == 0 and struct.unpack("<I", stats[1:5])[0] > 0
    for bad, msg in ((b"XXXX" + bytes([OP_PING]), b"bad magic"), (MAGIC + b"\x09", b"unknown op 9")):
        err = _raw(addr, bad, 5 + len(msg))
        assert err[0] == 1 and struct.unpack("<I", err[1:5])[0] == len(msg) and err[5:] == msg


def test_reference_client_against_port_server(sharded):
    ref_client = ref_serving.ShardClient(sharded[1].address, timeout=TIMEOUT)
    port_client = _client(sharded[1].address)
    assert ref_client.ping()
    before = ref_client.stats()
    got = ref_client.search(QUERIES, K)
    want = port_client.search(QUERIES, K)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert ref_client.stats()["searches"] == before["searches"] + 2
    ref_client.close()
    port_client.close()

    def broken(xq, k):
        raise RuntimeError("shard is cold")

    server = ShardServer(broken).start()
    try:
        client = ref_serving.ShardClient(server.address, timeout=TIMEOUT)
        with pytest.raises(RuntimeError, match="shard is cold"):
            client.search(QUERIES, K)
        client.close()
    finally:
        server.stop()


@pytest.mark.parametrize("kind_", sorted(STORES))
def test_port_client_and_front_end_against_reference_servers(tmp_path, kind_):
    half = N // 2
    stores = [_store(tmp_path / f"r{i}", rows, kind_, TpuVS)
              for i, rows in enumerate((CORPUS[:half], CORPUS[half:]))]
    servers = [ref_serving.ShardServer(ref_serving.vs_search_fn(vs, id_offset=off)).start()
               for vs, off in zip(stores, (0, half))]
    try:
        client = _client(servers[0].address)
        assert client.ping()
        d0, i0 = client.search(QUERIES, K)
        rd0, ri0 = ref_serving.vs_search_fn(stores[0])(QUERIES, K)
        np.testing.assert_array_equal(i0, ri0)
        np.testing.assert_array_equal(d0, rd0)
        assert client.stats() == {"searches": 1, "queries": len(QUERIES)}
        client.close()
        with _front_end([s.address for s in servers]) as fe:
            dists, ids = fe.search(QUERIES, K)
            assert fe.stats()["searches"] == 3
        whole = _store(tmp_path / "whole", CORPUS, kind_, TpuVS)(QUERIES, K)
        np.testing.assert_array_equal(ids, np.asarray(whole.indices))
        np.testing.assert_allclose(dists, np.asarray(whole.distances), atol=1e-5)
    finally:
        for s in servers:
            s.stop()


@pytest.mark.parametrize("kind_", sorted(STORES))
def test_port_front_end_gives_reference_front_end_ids(tmp_path, kind_):
    """Two port shards behind the port's front end against two TpuVS shards
    behind the reference's: ids equal, distances within 1e-5."""
    half = N // 2
    parts = ((CORPUS[:half], 0), (CORPUS[half:], half))
    port = [ShardServer(vs_search_fn(_store(tmp_path / f"p{i}", rows, kind_), id_offset=off)).start()
            for i, (rows, off) in enumerate(parts)]
    ref = [ref_serving.ShardServer(ref_serving.vs_search_fn(_store(tmp_path / f"r{i}", rows, kind_, TpuVS),
                                                            id_offset=off)).start()
           for i, (rows, off) in enumerate(parts)]
    try:
        with _front_end([s.address for s in port]) as fe:
            dists, ids = fe.search(QUERIES, K)
        ref_fe = ref_serving.SearchFrontEnd([s.address for s in ref])
        for c in ref_fe.clients:
            c.timeout = TIMEOUT
        want_d, want_i = ref_fe.search(QUERIES, K)
        ref_fe.close()
    finally:
        for s in (*port, *ref):
            s.stop()
    np.testing.assert_array_equal(ids, want_i)
    np.testing.assert_allclose(dists, want_d, atol=1e-5)


# ---- the served path's shape: quarters of a seeded corpus, saved as built ---


def test_row_shards_of_a_seeded_build(tmp_path):
    """Config 4 served as row quarters, at a tiny size: row shards of one seeded corpus
    (``synth_ivf_device_build(first_chunk=...)``) saved as built
    (``save_ivf_state``), each served by a ``TorchVS`` shard server with its
    id offset.  Each shard answers as the grouped probe on its state does
    (ids equal, distances within 1e-6), and the front end's merge equals the
    plain merge of those answers."""
    from lotus_tpu_torch.ops.bench_data import synth_ivf_device_build
    from lotus_tpu_torch.ops.ivf import save_ivf_state
    from lotus_tpu_torch.ops.ivf_probe import ivf_search_grouped_probe

    cfg = dict(d=32, n_clusters=32, chunk=2048, queries_b=32, gt_queries=16, k=K, block_align=512, seed=3,
               device="cpu")
    whole = synth_ivf_device_build(**cfg, n=4 * 2048, nlist=8)
    store_kw = dict(index_type="ivf", device_dtype="int8", int8_refine=True, nprobe=2, rescore=24,
                    int8_queries=True, device="cpu")
    servers, want = [], []
    for h in range(2):
        built = synth_ivf_device_build(**cfg, n=2 * 2048, nlist=4, first_chunk=2 * h)
        assert torch.equal(built["queries"], whole["queries"])  # the whole corpus's queries
        save_ivf_state(str(tmp_path / f"q{h}"), built["state"])
        vs = TorchVS(**store_kw)
        vs.load_index(str(tmp_path / f"q{h}"))
        s, i = ivf_search_grouped_probe(built["state"], built["queries"], K, nprobe=2, metric="ip",
                                        rescore=24, int8_queries=True)
        want.append((s.numpy(), i.numpy() + h * 2 * 2048))
        servers.append(ShardServer(vs_search_fn(vs, id_offset=h * 2 * 2048)).start())
    try:
        xq = whole["queries"].numpy()
        for server, (s, i) in zip(servers, want):
            got_d, got_i = _client(server.address).search(xq, K)
            np.testing.assert_array_equal(got_i, i)
            np.testing.assert_allclose(got_d, s, atol=1e-6)
        with _front_end([s.address for s in servers]) as fe:
            dists, ids = fe.search(xq, K)
    finally:
        for s in servers:
            s.stop()
    plain_d, plain_i = native.topk_merge_batch_reference(np.stack([w[0] for w in want], 1),
                                                         np.stack([w[1] for w in want], 1), K)
    np.testing.assert_array_equal(ids, plain_i)
    np.testing.assert_allclose(dists, plain_d, atol=1e-6)
    assert ids.min() >= 0 and ids.max() < 4 * 2048


def test_saved_state_loads_as_built(tmp_path):
    from lotus_tpu_torch.ops import io as index_io
    from lotus_tpu_torch.ops.bench_data import synth_ivf_device_build
    from lotus_tpu_torch.ops.ivf import load_ivf_state, save_ivf_state

    built = synth_ivf_device_build(n=2048, d=16, nlist=2, n_clusters=8, chunk=1024, queries_b=8, gt_queries=8,
                                   k=4, block_align=512, device="cpu")
    save_ivf_state(str(tmp_path), built["state"])
    meta = index_io.read_meta(str(tmp_path))
    with pytest.raises(ValueError, match="load it as int8"):
        load_ivf_state(str(tmp_path), meta, torch.float32, device="cpu")
    loaded = load_ivf_state(str(tmp_path), meta, torch.int8, refine_int4=False, device="cpu")
    assert "ivf_refine" not in loaded
    for name in ("ivf_vectors", "ivf_row_scales", "ivf_inv_perm", "ivf_row_ids", "centroids"):
        assert torch.equal(loaded[name], built["state"][name])
    state = dict(built["state"], ivf_vectors=built["state"]["ivf_vectors"].float())
    with pytest.raises(ValueError, match="int8 states only"):
        save_ivf_state(str(tmp_path / "f"), state)


def test_serving_runs_without_jax_pandas_or_lotus_tpu(tmp_path):
    """The serving tier and the host runtime import and answer with jax,
    pandas and lotus_tpu blocked, as on the card machine."""
    import os
    import subprocess
    import sys
    import textwrap

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = textwrap.dedent(
        f"""
        import sys
        for name in ("jax", "jaxlib", "pandas", "pydantic", "lotus_tpu"):
            sys.modules[name] = None  # any import of them raises ImportError
        sys.path.insert(0, {repo!r})
        import numpy as np
        from lotus_tpu_torch import TorchVS, native
        from lotus_tpu_torch.serving import SearchFrontEnd, ShardServer, vs_search_fn

        rows = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        servers = []
        for h in range(2):
            vs = TorchVS(index_type="flat", device="cpu")
            vs.index([], rows[32 * h : 32 * (h + 1)], {str(tmp_path)!r} + f"/s{{h}}")
            servers.append(ShardServer(vs_search_fn(vs, id_offset=32 * h)).start())
        with SearchFrontEnd([s.address for s in servers], timeout={TIMEOUT}) as fe:
            _, ids = fe.search(rows[[3, 40]], 2)
        for s in servers:
            s.stop()
        assert ids[:, 0].tolist() == [3, 40], ids
        assert len(set(native.union_find(np.array([[0, 1]]), 3).tolist())) == 2
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "pandas", "lotus_tpu")
               and sys.modules[m] is not None]
        assert not bad, bad
        print("ok")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, env=env,
                          cwd=str(tmp_path), timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]
