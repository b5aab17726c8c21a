"""PCD and PLY point-cloud file I/O, numpy only.

A copy of ``perception_tpu/io/pcd.py`` (templates and clouds for the
cuboid pipeline and the detection service): v0.7 ascii and binary PCD
with x/y/z fields (extra fields ignored; any other DATA mode raises),
non-finite rows dropped, and xyz PLY (ascii or binary_little_endian).
``runtime.read_pcd_native`` is the fast reader of the same files.
"""

from __future__ import annotations

import io as _io
from pathlib import Path
from typing import Union

import numpy as np

_SIZE_TYPE_TO_DTYPE = {
    (1, "I"): np.int8,
    (1, "U"): np.uint8,
    (2, "I"): np.int16,
    (2, "U"): np.uint16,
    (4, "I"): np.int32,
    (4, "U"): np.uint32,
    (4, "F"): np.float32,
    (8, "F"): np.float64,
}


def read_pcd(path: Union[str, Path]) -> np.ndarray:
    """Read a .pcd file, returning float32 (N, 3) xyz points.

    Non-finite rows (PCL NaN padding) are dropped.
    """
    raw = Path(path).read_bytes()
    header_end = 0
    fields, sizes, types, counts = [], [], [], []
    width = height = points = None
    data_mode = "ascii"

    stream = _io.BytesIO(raw)
    while True:
        line = stream.readline()
        if not line:
            raise ValueError(f"{path}: no DATA line found in PCD header")
        header_end = stream.tell()
        text = line.decode("ascii", errors="replace").strip()
        if not text or text.startswith("#"):
            continue
        key, _, value = text.partition(" ")
        key = key.upper()
        if key == "FIELDS":
            fields = value.split()
        elif key == "SIZE":
            sizes = [int(v) for v in value.split()]
        elif key == "TYPE":
            types = value.split()
        elif key == "COUNT":
            counts = [int(v) for v in value.split()]
        elif key == "WIDTH":
            width = int(value)
        elif key == "HEIGHT":
            height = int(value)
        elif key == "POINTS":
            points = int(value)
        elif key == "DATA":
            data_mode = value.strip().lower()
            break

    if points is None:
        points = (width or 0) * (height or 1)
    if not counts:
        counts = [1] * len(fields)

    if data_mode == "ascii":
        body = raw[header_end:].decode("ascii", errors="replace")
        arr = np.array(body.split(), dtype=np.float64)
        ncols = sum(counts)
        arr = arr.reshape(-1, ncols)
    elif data_mode == "binary":
        dtype_fields = []
        for f, s, t, c in zip(fields, sizes, types, counts):
            base = _SIZE_TYPE_TO_DTYPE[(s, t)]
            if c == 1:
                dtype_fields.append((f, base))
            else:
                dtype_fields.append((f, base, (c,)))
        rec = np.frombuffer(raw[header_end:], dtype=np.dtype(dtype_fields), count=points)
        cols = [rec[f].astype(np.float64).reshape(points, -1) for f in fields]
        arr = np.concatenate(cols, axis=1)
    else:
        raise ValueError(f"{path}: unsupported DATA mode {data_mode!r} (ascii/binary only)")

    col_of = {}
    col = 0
    for f, c in zip(fields, counts):
        col_of[f] = col
        col += c
    try:
        xyz = arr[:, [col_of["x"], col_of["y"], col_of["z"]]]
    except KeyError as e:
        raise ValueError(f"{path}: missing field {e} (FIELDS={fields})")
    xyz = xyz[np.isfinite(xyz).all(axis=1)]
    return np.ascontiguousarray(xyz, dtype=np.float32)


def write_pcd(path: Union[str, Path], points: np.ndarray, binary: bool = False) -> None:
    """Write float32 (N, 3) xyz points as a v0.7 .pcd file."""
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    n = len(points)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        "FIELDS x y z\n"
        "SIZE 4 4 4\n"
        "TYPE F F F\n"
        "COUNT 1 1 1\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(points.tobytes())
        else:
            np.savetxt(f, points, fmt="%f")


def read_ply(path: Union[str, Path]) -> np.ndarray:
    """Read xyz from a PLY file (ascii or binary_little_endian) ->
    float32 (N, 3).

    Covers the viewer input of the reference
    (object_detection/scripts/ply_viewer.py:1-9, which hands
    merged_cloud.ply to open3d); extra per-vertex properties are
    skipped, non-vertex elements ignored.
    """
    path = Path(path)
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n_vertex = 0
        props = []          # (name, dtype) of the vertex element
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unterminated PLY header")
            tok = line.decode("ascii", "replace").strip().split()
            if not tok:
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                in_vertex = tok[1] == "vertex"
                if in_vertex:
                    n_vertex = int(tok[2])
            elif tok[0] == "property" and in_vertex:
                if tok[1] == "list":
                    raise ValueError("list property in vertex element")
                props.append((tok[2], tok[1]))
            elif tok[0] == "end_header":
                break
        type_map = {
            "float": "<f4", "float32": "<f4", "double": "<f8",
            "float64": "<f8", "uchar": "u1", "uint8": "u1",
            "char": "i1", "int8": "i1", "short": "<i2", "ushort": "<u2",
            "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
        }
        names = [n for n, _ in props]
        for axis in ("x", "y", "z"):
            if axis not in names:
                raise ValueError(f"{path}: vertex element lacks '{axis}'")
        if fmt == "ascii":
            rows = []
            for _ in range(n_vertex):
                vals = f.readline().split()
                rows.append([float(vals[names.index(a)]) for a in ("x", "y", "z")])
            return np.asarray(rows, np.float32)
        if fmt == "binary_little_endian":
            dt = np.dtype([(n, type_map[t]) for n, t in props])
            data = np.frombuffer(f.read(dt.itemsize * n_vertex), dt, n_vertex)
            return np.stack(
                [data["x"], data["y"], data["z"]], axis=-1
            ).astype(np.float32)
        raise ValueError(f"{path}: unsupported PLY format {fmt}")


def write_ply(path: Union[str, Path], points: np.ndarray,
              binary: bool = False) -> None:
    """Write an xyz cloud as PLY (ascii or binary_little_endian)."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    header = (
        "ply\nformat {}\nelement vertex {}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "end_header\n"
    ).format("binary_little_endian 1.0" if binary else "ascii 1.0",
             len(points))
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(points.astype("<f4").tobytes())
        else:
            np.savetxt(f, points, fmt="%f")
