"""The serving tier of the port: shard servers, their client and the front end.

Counterpart of ``lotus_tpu/serving/__init__.py``, byte for byte on the wire,
so a client of either package talks to a server of the other.  When a corpus
outgrows one card, each shard host serves its rows and a front end merges
their top-k:

- :class:`ShardServer` — a thin TCP server around any search engine (a
  ``VS`` such as ``TorchVS``, or a plain callable): receives a query batch,
  runs the local search, sends back the shard's top-k with GLOBAL row ids.
- :class:`ShardClient` — the matching client (one persistent connection,
  one reconnect after a stale one).
- :class:`SearchFrontEnd` — fans a query batch out to every shard server in
  parallel and merges the (B, n_shards, k) candidates in one call into the
  port's host runtime (``lotus_tpu_torch.native.topk_merge_batch``, C++).

The wire format is a fixed little-endian binary framing (no pickle):

Request frame:   b"LTSV" | u8 op | op payload
  op=1 SEARCH:   u32 n_queries | u32 dim | u32 k | f32[n_queries * dim]
  op=2 PING:     (empty)
  op=3 STATS:    (empty)
Response frame:  u8 status | payload
  status=0 ok:   SEARCH -> u32 n_queries | u32 k | f32[n*k] | i64[n*k]
                 PING   -> (empty)
                 STATS  -> u32 len | utf-8 JSON {"searches": N, "queries": N}
  status=1 err:  u32 len | utf-8 message
"""

from __future__ import annotations

import json
import logging
import socket
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Sequence

import numpy as np

from lotus_tpu_torch import native

MAGIC = b"LTSV"
OP_SEARCH = 1
OP_PING = 2
OP_STATS = 3  # -> u32 len | utf-8 JSON {"searches": N, "queries": N}

logger = logging.getLogger("lotus_tpu_torch")

SearchFn = Callable[[np.ndarray, int], tuple[np.ndarray, np.ndarray]]


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = conn.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed mid-frame")
        got += r
    return bytes(buf)


def vs_search_fn(vs: Any, id_offset: int = 0) -> SearchFn:
    """Adapt a VS (4-method store contract) into a serving search function.

    ``id_offset`` maps the shard's local row ids into the global id space —
    shard s of a row-partitioned corpus serves rows [offset, offset + n_s).
    """

    def search(xq: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        out = vs(xq, k)
        dists = np.asarray(out.distances, dtype=np.float32)
        ids = np.asarray(out.indices, dtype=np.int64)
        ids = np.where(ids >= 0, ids + id_offset, ids)
        return dists, ids

    return search


class ShardServer:
    """Serve one index shard's search over TCP.

    Args:
        search: the local engine — ``(xq float32 [B, d], k) -> (dists
            float32 [B, k], global ids int64 [B, k])``.  Use
            :func:`vs_search_fn` to adapt a VS.
        host/port: bind address; port 0 picks a free port (see ``address``).
    """

    def __init__(self, search: SearchFn, host: str = "127.0.0.1", port: int = 0) -> None:
        self._search = search
        self.stats = {"searches": 0, "queries": 0}
        self._stats_lock = threading.Lock()
        self._sock = socket.create_server((host, port))
        self._sock.settimeout(0.25)  # so the accept loop can observe stop()
        self._stopping = threading.Event()
        self._thread: threading.Thread | None = None
        self._conn_threads: list[threading.Thread] = []
        # Established connections, so stop() can terminate them: closing only
        # the *listening* socket leaves persistent connections alive, and a
        # "dead" shard would keep serving them.
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()

    @property
    def address(self) -> tuple[str, int]:
        return self._sock.getsockname()[:2]

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ShardServer":
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stopping.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._sock.close()
        # Terminate established connections too: per-connection threads block
        # in _recv_exact and would otherwise serve one more request each on
        # their persistent sockets after "death".
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        for t in self._conn_threads:
            t.join(timeout=5)

    def __enter__(self) -> "ShardServer":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # -------------------------------------------------------------- serving
    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            with self._conns_lock:
                if self._stopping.is_set():
                    conn.close()
                    break
                self._conns.add(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,), daemon=True)
            t.start()
            # Prune finished threads so a long-lived server with churning
            # clients doesn't retain one Thread object per connection ever.
            self._conn_threads = [x for x in self._conn_threads if x.is_alive()]
            self._conn_threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            self._serve_conn_loop(conn)
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _serve_conn_loop(self, conn: socket.socket) -> None:
        with conn:
            while not self._stopping.is_set():
                try:
                    head = _recv_exact(conn, 5)
                except (ConnectionError, OSError):
                    return
                # A frame that arrived concurrently with stop(): a dead shard
                # must not serve it (partial-serving contract).
                if self._stopping.is_set():
                    return
                try:
                    if head[:4] != MAGIC:
                        raise ValueError("bad magic")
                    op = head[4]
                    if op == OP_PING:
                        conn.sendall(b"\x00")
                    elif op == OP_STATS:
                        with self._stats_lock:
                            payload = json.dumps(self.stats).encode()
                        conn.sendall(b"\x00" + struct.pack("<I", len(payload)) + payload)
                    elif op == OP_SEARCH:
                        b, d, k = struct.unpack("<III", _recv_exact(conn, 12))
                        raw = _recv_exact(conn, 4 * b * d)
                        xq = np.frombuffer(raw, dtype="<f4").reshape(b, d)
                        dists, ids = self._search(xq, int(k))
                        with self._stats_lock:
                            self.stats["searches"] += 1
                            self.stats["queries"] += int(b)
                        dists = np.ascontiguousarray(dists, dtype="<f4")
                        ids = np.ascontiguousarray(ids, dtype="<i8")
                        conn.sendall(
                            b"\x00"
                            + struct.pack("<II", dists.shape[0], dists.shape[1])
                            + dists.tobytes()
                            + ids.tobytes()
                        )
                    else:
                        raise ValueError(f"unknown op {op}")
                except (ConnectionError, OSError):
                    return
                except Exception as e:  # protocol-level error -> status frame
                    logger.warning(f"ShardServer: request failed: {e}")
                    msg = str(e).encode()
                    try:
                        conn.sendall(b"\x01" + struct.pack("<I", len(msg)) + msg)
                    except OSError:
                        return


class ShardClient:
    """Client for one :class:`ShardServer` (persistent connection)."""

    def __init__(self, address: tuple[str, int], timeout: float = 900.0) -> None:
        # The default timeout is generous: a shard's FIRST search may load
        # its store onto the card, and a partial answer is worse than a
        # slow one.
        self.address = (address[0], int(address[1]))
        self.timeout = timeout
        self._conn: socket.socket | None = None
        self._lock = threading.Lock()

    def _connect(self) -> socket.socket:
        if self._conn is None:
            self._conn = socket.create_connection(self.address, timeout=self.timeout)
        return self._conn

    def _read_status(self, conn: socket.socket) -> None:
        status = _recv_exact(conn, 1)[0]
        if status != 0:
            (n,) = struct.unpack("<I", _recv_exact(conn, 4))
            raise RuntimeError(f"shard {self.address}: {_recv_exact(conn, n).decode()}")

    def ping(self) -> bool:
        with self._lock:
            conn = self._connect()
            conn.sendall(MAGIC + bytes([OP_PING]))
            self._read_status(conn)
        return True

    def stats(self) -> dict:
        """The shard's cumulative serving counters (JSON over the wire)."""
        with self._lock:
            conn = self._connect()
            conn.sendall(MAGIC + bytes([OP_STATS]))
            self._read_status(conn)
            (n,) = struct.unpack("<I", _recv_exact(conn, 4))
            return json.loads(_recv_exact(conn, n).decode())

    def search(self, xq: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        xq = np.ascontiguousarray(np.asarray(xq, dtype="<f4"))
        if xq.ndim == 1:
            xq = xq[None, :]
        with self._lock:
            try:
                return self._search_once(xq, k)
            except (ConnectionError, socket.timeout, OSError):
                # Stale persistent connection (server restart, idle reset):
                # each request is a self-contained frame on its own exchange,
                # so one reconnect-and-resend is safe.  A second failure means
                # the shard is really down — let it raise.
                self.close()
                return self._search_once(xq, k)

    def _search_once(self, xq: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        conn = self._connect()
        conn.sendall(
            MAGIC
            + bytes([OP_SEARCH])
            + struct.pack("<III", xq.shape[0], xq.shape[1], k)
            + xq.tobytes()
        )
        self._read_status(conn)
        b, kk = struct.unpack("<II", _recv_exact(conn, 8))
        dists = np.frombuffer(_recv_exact(conn, 4 * b * kk), dtype="<f4").reshape(b, kk)
        ids = np.frombuffer(_recv_exact(conn, 8 * b * kk), dtype="<i8").reshape(b, kk)
        return dists.copy(), ids.copy()

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None


class SearchFrontEnd:
    """Fan a query batch out to shard servers and merge the results.

    Per-shard searches run concurrently (one thread per shard — the work is
    network+device-bound); the (B, n_shards, k) candidate pool is merged to
    (B, k) by the native batched k-way merge.  Shards that fail raise — a
    partial answer from a row-partitioned corpus is silently wrong, so the
    caller decides about retries.
    """

    def __init__(self, addresses: Sequence[tuple[str, int]], timeout: float = 900.0) -> None:
        if not addresses:
            raise ValueError("SearchFrontEnd needs at least one shard address")
        # ``timeout``: each client's socket timeout (``ShardClient``'s default).
        self.clients = [ShardClient(a, timeout=timeout) for a in addresses]
        self._pool = ThreadPoolExecutor(max_workers=len(self.clients))
        # Addresses of shards that failed during the most recent
        # allow_partial search (empty after a fully-served one).
        self.last_failed_shards: list[tuple[str, int]] = []

    def search(
        self, xq: np.ndarray, k: int, *, allow_partial: bool = False
    ) -> tuple[np.ndarray, np.ndarray]:
        """Fan out, merge.  A dead shard raises by default; with
        ``allow_partial=True`` the live shards' merge is returned instead
        and the casualties are recorded in ``last_failed_shards`` (the
        caller OWNS the recall gap — a row-partitioned corpus is missing
        that shard's rows entirely)."""
        xq = np.asarray(xq, dtype=np.float32)
        if xq.ndim == 1:
            xq = xq[None, :]
        # Reset up front: in non-partial mode a shard failure propagates out
        # of the fan-out below, and stale casualties from an earlier search
        # would otherwise mislead callers inspecting this after catching.
        self.last_failed_shards = []

        def one(c: ShardClient):
            try:
                return c.search(xq, k), None
            except Exception as e:
                if allow_partial:
                    return None, (c.address, e)
                raise

        results = list(self._pool.map(one, self.clients))
        parts = [r for r, _ in results if r is not None]
        failures = [f for _, f in results if f is not None]
        self.last_failed_shards = [addr for addr, _ in failures]
        if not parts:
            raise RuntimeError(
                f"all {len(self.clients)} shards failed; first: {failures[0][1]}"
            )
        if failures:
            logger.warning(
                "serving %d/%d shards (failed: %s)",
                len(parts), len(self.clients), self.last_failed_shards,
            )
        dists = np.stack([p[0] for p in parts], axis=1)  # (B, n_live, k)
        ids = np.stack([p[1] for p in parts], axis=1)
        return native.topk_merge_batch(dists, ids, k)

    def stats(self) -> dict:
        """Aggregate serving counters across shards (plus per-shard detail)."""
        per_shard = list(self._pool.map(lambda c: c.stats(), self.clients))
        totals: dict[str, Any] = {}
        for s in per_shard:
            for key, val in s.items():
                totals[key] = totals.get(key, 0) + val
        return {**totals, "shards": per_shard}

    def close(self) -> None:
        for c in self.clients:
            c.close()
        self._pool.shutdown(wait=False)

    def __enter__(self) -> "SearchFrontEnd":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
