"""A reader for the msgpack files that ``flax.serialization`` writes.

The repo's trained fixtures (``tests/fixtures/*.msgpack``) are flax
parameter trees saved with ``flax.serialization.to_bytes``. This module
reads them with the standard library and numpy alone, so loading them
needs neither flax nor the ``msgpack`` package.

It reads the subset of msgpack that flax writes: maps, arrays, str, bin,
int, float, nil and bool, and flax's extension types 1 (an ndarray,
itself a msgpack triple ``(shape, dtype name, raw bytes)``), 2 (a Python
complex) and 3 (a numpy scalar). Arrays that flax split into chunks
(leaves over 1 GiB) are joined again. ``msgpack_restore`` returns what
``flax.serialization.msgpack_restore`` returns: nested dicts and lists
whose array leaves are read-only numpy views of the file's bytes.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw  # str as bytes (flax reads an ndarray's dtype name so)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated input")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        if code == _EXT_COMPLEX:
            real, imag = _Reader(payload).value()
            return complex(real, imag)
        raise ValueError(f"msgpack: extension type {code} is not one flax writes")

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack(">" + "BHI"[b - 0xC4])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack(">" + "BHI"[b - 0xC7])
            return self.ext(self.unpack(">b"), n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xCF:
            return self.unpack(">" + "BHIQ"[b - 0xCC])
        if 0xD0 <= b <= 0xD3:
            return self.unpack(">" + "bhiq"[b - 0xD0])
        if 0xD4 <= b <= 0xD8:
            code = self.unpack(">b")
            return self.ext(code, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.string(self.unpack(">" + "BHI"[b - 0xD9]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">" + "HI"[b - 0xDC]))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">" + "HI"[b - 0xDE]))
        raise ValueError(f"msgpack: byte 0x{b:02x} starts no value")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, (str, bytes)):
                raise ValueError(f"msgpack: map key {key!r} is not a string")
            out[key] = self.value()
        return out


def _ndarray(payload: bytes) -> np.ndarray:
    """flax's ndarray encoding: msgpack ``(shape, dtype name, raw bytes)``."""
    reader = _Reader(payload, raw=True)
    shape, dtype_name, buffer = reader.value()
    if reader.pos != len(payload):
        raise ValueError("msgpack: trailing bytes in an ndarray")
    if dtype_name == b"bfloat16":
        raise ValueError("msgpack: bfloat16 leaves need a bfloat16 numpy dtype")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape, order="C")


def _unchunk(tree):
    """Join flax's chunked array leaves (``__msgpack_chunked_array__``)."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        def as_tuple(d):
            return tuple(d[str(i)] for i in range(len(d)))

        return np.concatenate(as_tuple(tree["chunks"])).reshape(as_tuple(tree["shape"]))
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes):
    """The tree that ``flax.serialization.msgpack_restore(data)`` returns."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(data):
        raise ValueError("msgpack: trailing bytes after the tree")
    return _unchunk(tree)


def read_tree(path) -> dict:
    """The flax tree saved at ``path`` (``flax.serialization.to_bytes``)."""
    return msgpack_restore(Path(path).read_bytes())
