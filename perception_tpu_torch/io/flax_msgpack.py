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

``msgpack_serialize`` and ``write_tree`` are the inverse for what the
fixtures hold: nested dicts of ndarrays (and str, int, float, bool, None
leaves), written as ``flax.serialization.to_bytes`` writes them: each
map's keys in sorted order (``jax.tree_util`` rebuilds dicts so), each
value in msgpack's shortest encoding, an ndarray as extension type 1.
Leaves of 1 GiB and more, which flax splits into chunks, are refused.
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


_MAX_CHUNK = 2 ** 30  # flax's MAX_CHUNK_SIZE: larger leaves are written in chunks


def _pack_len(n: int, first: int, widths: str = "BHI") -> bytes:
    """A length header: the code ``first`` + i and ``n`` in the i-th of
    ``widths`` (big-endian), the smallest that holds it."""
    for i, fmt in enumerate(widths):
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([first + i]) + struct.pack(">" + fmt, n)
    raise ValueError("msgpack: length too large")


def _pack_int(n: int) -> bytes:
    if 0 <= n <= 0x7F:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt, limit in ((0xCC, "B", 0xFF), (0xCD, "H", 0xFFFF), (0xCE, "I", 0xFFFFFFFF),
                                 (0xCF, "Q", 0xFFFFFFFFFFFFFFFF)):
            if n <= limit:
                return bytes([code]) + struct.pack(">" + fmt, n)
    else:
        for code, fmt, limit in ((0xD0, "b", 0x80), (0xD1, "h", 0x8000), (0xD2, "i", 0x80000000),
                                 (0xD3, "q", 0x8000000000000000)):
            if -n <= limit:
                return bytes([code]) + struct.pack(">" + fmt, n)
    raise ValueError(f"msgpack: integer {n} out of range")


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    head = bytes([0xA0 | len(b)]) if len(b) < 32 else _pack_len(len(b), 0xD9)
    return head + b


def _pack_bin(b: bytes) -> bytes:
    return _pack_len(len(b), 0xC4) + b


def _pack_ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n]]) + struct.pack(">b", code) + payload
    return _pack_len(n, 0xC7) + struct.pack(">b", code) + payload


def _pack_ndarray(x: np.ndarray) -> bytes:
    """flax's ndarray encoding: msgpack ``(shape, dtype name, raw bytes)``."""
    if x.nbytes > _MAX_CHUNK:
        raise ValueError("msgpack: leaves of 1 GiB and more are chunked by flax; not written here")
    return _pack_ext(_EXT_NDARRAY, _pack([list(x.shape), x.dtype.name, x.tobytes("C")]))


def _pack(x) -> bytes:
    if x is None:
        return b"\xc0"
    if x is True or x is False:
        return b"\xc3" if x else b"\xc2"
    if isinstance(x, np.ndarray):
        return _pack_ndarray(x)
    if isinstance(x, np.generic):
        return _pack_ext(_EXT_NPSCALAR, _pack([[], x.dtype.name, np.asarray(x).tobytes("C")]))
    if isinstance(x, int):
        return _pack_int(x)
    if isinstance(x, float):
        return b"\xcb" + struct.pack(">d", x)
    if isinstance(x, str):
        return _pack_str(x)
    if isinstance(x, (bytes, bytearray)):
        return _pack_bin(bytes(x))
    if isinstance(x, (list, tuple)):
        n = len(x)
        head = bytes([0x90 | n]) if n < 16 else _pack_len(n, 0xDC, "HI")
        return head + b"".join(_pack(v) for v in x)
    if isinstance(x, dict):
        n = len(x)
        head = bytes([0x80 | n]) if n < 16 else _pack_len(n, 0xDE, "HI")
        return head + b"".join(_pack_str(str(k)) + _pack(x[k]) for k in sorted(x, key=str))
    raise TypeError(f"msgpack: cannot write a {type(x).__name__}")


def msgpack_serialize(tree) -> bytes:
    """The bytes ``flax.serialization.to_bytes(tree)`` writes for a tree of
    nested dicts and lists over ndarrays."""
    return _pack(tree)


def write_tree(path, tree) -> None:
    """Write ``tree`` at ``path`` as ``flax.serialization.to_bytes`` does."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(msgpack_serialize(tree))
