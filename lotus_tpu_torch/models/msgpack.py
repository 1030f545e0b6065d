"""Flax's ``flax_model.msgpack`` without the ``msgpack`` package.

A hand-written msgpack decoder (maps, arrays, str, bin, ints, floats, nil,
bool and ext) and Flax's layer on it (``flax/serialization.py``): an
ndarray is ext type 1 whose payload is itself a msgpack of (shape, dtype
name, raw C-order bytes), a numpy scalar ext type 3 of the same form, and a
leaf larger than ``MAX_CHUNK_SIZE`` (2**30 bytes) is stored as a dict
``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {"0": ...}}``
of its flattened pieces, which the reader joins back.  Arrays are zero-copy
views of the file's bytes; ``bfloat16`` (which numpy lacks) is widened to
float32 exactly.  A truncated or malformed file raises ``ValueError``
naming it.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_NPSCALAR = 1, 3


class _Reader:
    def __init__(self, data: bytes | memoryview):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"truncated: {n} bytes wanted at offset {self.pos} of {len(self.data)}")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        if b in (0xC4, 0xC5, 0xC6):
            return self.take(self.unpack(">" + "BHI"[b - 0xC4]))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack(">" + "BHI"[b - 0xC7])
            return self.ext(self.unpack(">b"), n)
        if b in (0xCA, 0xCB):
            return self.unpack(">f" if b == 0xCA else ">d")
        if 0xCC <= b <= 0xD3:
            return self.unpack(">" + "BHIQbhiq"[b - 0xCC])
        if 0xD4 <= b <= 0xD8:
            kind = self.unpack(">b")
            return self.ext(kind, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.text(self.unpack(">" + "BHI"[b - 0xD9]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"byte 0x{b:02x} at offset {self.pos - 1} begins no msgpack value")

    def text(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, kind: int, n: int) -> Any:
        payload = self.take(n)
        if kind in (EXT_NDARRAY, EXT_NPSCALAR):
            arr = _ndarray(payload)
            return arr if kind == EXT_NDARRAY else arr[()]
        raise ValueError(f"msgpack ext type {kind} is not an array")


def _ndarray(payload: memoryview) -> np.ndarray:
    """Flax's ndarray payload: a msgpack (shape, dtype name, raw bytes)."""
    shape, name, raw = unpackb(payload)
    name = name if isinstance(name, str) else str(name, "utf-8")
    if name == "bfloat16":
        wide = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
        return wide.view(np.float32).reshape(shape)
    return np.frombuffer(raw, np.dtype(name)).reshape(shape)


def unpackb(data: bytes | memoryview) -> Any:
    """One msgpack value that fills ``data``."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the msgpack value")
    return out


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if tree.get(CHUNKED):
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def _leaves(tree: dict):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def read_flax_msgpack(path: str) -> dict:
    """The nested parameters of a ``flax_model.msgpack`` (numpy arrays),
    chunked leaves joined back; a file whose leaves are not all arrays, or
    that holds none, raises ``ValueError``."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        tree = _unchunk(unpackb(data))
    except (ValueError, KeyError, IndexError, TypeError, UnicodeDecodeError, struct.error) as e:
        raise ValueError(f"{path} is not a Flax msgpack checkpoint: {e}") from e
    if not isinstance(tree, dict):
        raise ValueError(f"{path} is not a Flax msgpack checkpoint: its top value is a {type(tree).__name__}")
    leaves = list(_leaves(tree))
    if not leaves:
        raise ValueError(f"{path} is not a Flax msgpack checkpoint: it holds no arrays")
    odd = next((leaf for leaf in leaves if not isinstance(leaf, (np.ndarray, np.generic))), None)
    if odd is not None:
        raise ValueError(f"{path} is not a Flax msgpack checkpoint: a leaf is a {type(odd).__name__}, not an array")
    return tree
