"""The port's host runtime: ctypes bindings for ``lotus_native.cpp``.

Counterpart of ``lotus_tpu/native/__init__.py``, with the same names and
signatures (``available``, ``union_find``, ``topk_merge``,
``topk_merge_batch``, ``write_array``, ``read_array``) over a copy of the
reference's C++ (``lotus_native.cpp`` beside this file), so both libraries
give the same answers bit for bit:

- union_find: connected components over duplicate-pair edges (sem_dedup)
- topk_merge / topk_merge_batch: k-way merge of per-shard descending top-k
  lists (the serving front end, ``lotus_tpu_torch.serving``)
- write_array / read_array: raw array files behind a CRC32-checked header

Two differences from the reference, on purpose:

- The library is built at first use with ``g++ -O3 -fPIC -std=c++17
  -shared`` into ``build/lotus_tpu_torch/`` (beside the package, as the CUDA
  kernels are, through the same ``_build.build_library``), named by a
  digest of the source and the flags, never into the source tree.
- There is no fallback.  The reference answers in Python when g++ fails
  (``native/__init__.py:73-75``); here every entry point raises with the
  compiler's output.  The reference's Python versions stay below as the
  plain versions (``*_reference``), which the tests hold the library to;
  no entry point calls them.

The plain merge is the reference's fallback, which disagrees with the C++
(and so with both libraries) in two cases: tied scores come out in the
order of a stable sort, not of libstdc++'s heap, and a ``-1`` inside a list
is skipped where the C++ ends that list at its first ``-1``.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
import zlib
from pathlib import Path

import numpy as np

from lotus_tpu_torch._build import BUILD_DIR, build_library

SOURCE = Path(__file__).resolve().parent / "lotus_native.cpp"
CXX = "g++"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
MISSING_SCORE = -3.0e38  # the score of a slot no candidate fills

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_f32p, _i64p, _u8p = (ctypes.POINTER(t) for t in (ctypes.c_float, ctypes.c_int64, ctypes.c_uint8))
_i64 = ctypes.c_int64


def build() -> Path:
    """Compile the library (once per source digest) and return its path;
    raises ``RuntimeError`` with the compiler's output when g++ fails."""
    def compile_to(out: Path) -> None:
        try:
            run = subprocess.run([CXX, *CXX_FLAGS, "-o", str(out), str(SOURCE)],
                                 capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"native library: cannot run {CXX} ({e})") from e
        if run.returncode != 0:
            raise RuntimeError(f"native library: {CXX} failed ({run.returncode}):\n{run.stdout}{run.stderr}")

    return build_library(BUILD_DIR, "liblotus_native", SOURCE.read_bytes() + " ".join([CXX, *CXX_FLAGS]).encode(),
                         compile_to)


def lib() -> ctypes.CDLL:
    """The loaded library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            handle.lotus_union_find.argtypes = [_i64p, _i64, _i64, _i64p]
            handle.lotus_union_find.restype = None
            handle.lotus_topk_merge.argtypes = [_f32p, _i64p, _i64, _i64, _i64, _f32p, _i64p]
            handle.lotus_topk_merge.restype = None
            handle.lotus_topk_merge_batch.argtypes = [_f32p, _i64p, _i64, _i64, _i64, _i64, _f32p, _i64p]
            handle.lotus_topk_merge_batch.restype = None
            handle.lotus_write_array.argtypes = [ctypes.c_char_p, _u8p, _i64]
            handle.lotus_write_array.restype = ctypes.c_int
            handle.lotus_read_array.argtypes = [ctypes.c_char_p, _u8p, _i64]
            handle.lotus_read_array.restype = ctypes.c_int64
            _lib = handle
    return _lib


def available() -> bool:
    """True when the library builds and loads.  The entry points raise
    instead of answering without it."""
    try:
        lib()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctype)


# ------------------------------------------------------------- union-find
def union_find(edges: np.ndarray, n_nodes: int) -> np.ndarray:
    """Component label per node for an (E, 2) int array of edges."""
    edges = np.ascontiguousarray(np.asarray(edges, dtype=np.int64).reshape(-1, 2))
    if len(edges) and (edges.min() < 0 or edges.max() >= n_nodes):
        raise ValueError(f"edge ids must lie in [0, {n_nodes})")  # the C++ would index past its arrays
    out = np.empty(n_nodes, dtype=np.int64)
    lib().lotus_union_find(_ptr(edges, _i64p), len(edges), n_nodes, _ptr(out, _i64p))
    return out


def union_find_reference(edges: np.ndarray, n_nodes: int) -> np.ndarray:
    """The plain version: the reference's Python union-find (no union by
    rank, so its labels name other roots than the library's; the
    components are the same)."""
    parent = list(range(n_nodes))

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for a, b in np.asarray(edges, dtype=np.int64).reshape(-1, 2).tolist():
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra
    return np.array([find(i) for i in range(n_nodes)], dtype=np.int64)


# ------------------------------------------------------------- top-k merge
def topk_merge(scores: np.ndarray, ids: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Merge (n_lists, list_len) descending candidate lists into global
    top-k. ids of -1 mark missing entries."""
    scores = np.ascontiguousarray(np.asarray(scores, dtype=np.float32))
    ids = np.ascontiguousarray(np.asarray(ids, dtype=np.int64))
    if scores.ndim != 2 or scores.shape != ids.shape:
        raise ValueError(f"expected matching (n_lists, list_len) arrays, got {scores.shape} / {ids.shape}")
    out_s = np.empty(k, dtype=np.float32)
    out_i = np.empty(k, dtype=np.int64)
    lib().lotus_topk_merge(_ptr(scores, _f32p), _ptr(ids, _i64p), scores.shape[0], scores.shape[1], k,
                           _ptr(out_s, _f32p), _ptr(out_i, _i64p))
    return out_s, out_i


def topk_merge_batch(scores: np.ndarray, ids: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-query merge of (B, n_lists, list_len) descending candidate lists
    into (B, k) global top-k — one native call for the whole batch."""
    scores = np.ascontiguousarray(np.asarray(scores, dtype=np.float32))
    ids = np.ascontiguousarray(np.asarray(ids, dtype=np.int64))
    if scores.ndim != 3 or scores.shape != ids.shape:
        raise ValueError(f"expected matching (B, n_lists, list_len) arrays, got {scores.shape} / {ids.shape}")
    b, n_lists, list_len = scores.shape
    out_s = np.empty((b, k), dtype=np.float32)
    out_i = np.empty((b, k), dtype=np.int64)
    lib().lotus_topk_merge_batch(_ptr(scores, _f32p), _ptr(ids, _i64p), b, n_lists, list_len, k,
                                 _ptr(out_s, _f32p), _ptr(out_i, _i64p))
    return out_s, out_i


def topk_merge_reference(scores: np.ndarray, ids: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """The plain version: the reference's fallback, a stable sort of every
    candidate whose id is not -1 (see the module docstring for where it
    differs from the library)."""
    flat_s = np.asarray(scores, dtype=np.float32).ravel()
    flat_i = np.asarray(ids, dtype=np.int64).ravel()
    valid = flat_i >= 0
    flat_s, flat_i = flat_s[valid], flat_i[valid]
    order = np.argsort(-flat_s, kind="stable")[:k]
    out_s = np.full(k, MISSING_SCORE, np.float32)
    out_i = np.full(k, -1, np.int64)
    out_s[: len(order)] = flat_s[order]
    out_i[: len(order)] = flat_i[order]
    return out_s, out_i


def topk_merge_batch_reference(scores: np.ndarray, ids: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """The plain version of ``topk_merge_batch``: one plain merge a query."""
    merged = [topk_merge_reference(s, i, k) for s, i in zip(scores, ids)]
    return np.stack([m[0] for m in merged]), np.stack([m[1] for m in merged])


# ---------------------------------------------------------- checksummed IO
# File layout: b"LTPU" | u32 version (1) | u64 byte length | u32 CRC32 | payload.
def write_array(path: str, arr: np.ndarray) -> None:
    """Write raw bytes with a CRC32-checked header."""
    data = np.ascontiguousarray(arr).view(np.uint8).ravel()
    rc = lib().lotus_write_array(path.encode(), _ptr(data, _u8p), len(data))
    if rc != 0:
        raise OSError(f"lotus_write_array failed with code {rc} for {path}")


def read_array(path: str, dtype: np.dtype, shape: tuple[int, ...]) -> np.ndarray:
    """Read a checksummed array; raises on corruption."""
    expected = int(np.prod(shape)) * np.dtype(dtype).itemsize
    out = np.empty(expected, dtype=np.uint8)
    got = lib().lotus_read_array(path.encode(), _ptr(out, _u8p), expected)
    if got == -3:
        raise OSError(f"checksum mismatch reading {path} (corrupt index file)")
    if got < 0:
        raise OSError(f"lotus_read_array failed with code {got} for {path}")
    if got != expected:
        raise OSError(f"size mismatch reading {path}: {got} != {expected}")
    return out.view(dtype).reshape(shape)


def write_array_reference(path: str, arr: np.ndarray) -> None:
    """The plain version of ``write_array`` (``zlib``'s CRC32)."""
    data = np.ascontiguousarray(arr).view(np.uint8).ravel().tobytes()
    with open(path, "wb") as f:
        f.write(b"LTPU" + (1).to_bytes(4, "little") + len(data).to_bytes(8, "little")
                + zlib.crc32(data).to_bytes(4, "little") + data)


def read_array_reference(path: str, dtype: np.dtype, shape: tuple[int, ...]) -> np.ndarray:
    """The plain version of ``read_array``."""
    with open(path, "rb") as f:
        if f.read(4) != b"LTPU":
            raise OSError(f"bad magic in {path}")
        f.read(4)
        blen = int.from_bytes(f.read(8), "little")
        crc = int.from_bytes(f.read(4), "little")
        payload = f.read(blen)
    if zlib.crc32(payload) != crc:
        raise OSError(f"checksum mismatch reading {path} (corrupt index file)")
    expected = int(np.prod(shape)) * np.dtype(dtype).itemsize
    if blen != expected:
        raise OSError(f"size mismatch reading {path}: {blen} != {expected}")
    return np.frombuffer(payload, dtype=dtype).reshape(shape)
