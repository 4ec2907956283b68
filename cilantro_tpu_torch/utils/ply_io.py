"""PLY point-cloud I/O on numpy structured arrays (port of
``cilantro_tpu/utils/ply_io.py``, the same host code: a file either
package writes reads back the same in the other).

Replaces the reference's tinyply-backed reader/writer
(``include/cilantro/utilities/ply_io.hpp:43-243`` and the PLY ctor / ``toPLYFile``
of ``utilities/point_cloud.hpp:118-121``). Pure Python + numpy: PLY parsing is
host I/O, not a device hot path; the C++ codec for large files is
:func:`cilantro_tpu_torch.native.ply_read_native`.

Supports ``format ascii 1.0``, ``format binary_little_endian 1.0`` and
``format binary_big_endian 1.0`` in BOTH directions (tinyply reads and
writes either byte order; pass ``big_endian=True`` to the writer).
"""

from __future__ import annotations

import io
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_INV_DTYPES = {
    "i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
    "i4": "int", "u4": "uint", "f4": "float", "f8": "double",
}


@dataclass
class PLYElement:
    name: str
    count: int
    properties: List[Tuple[str, str]] = field(default_factory=list)  # (name, np dtype)
    list_properties: List[Tuple[str, str, str]] = field(default_factory=list)
    data: Optional[np.ndarray] = None  # structured array
    list_data: Optional[Dict[str, List[np.ndarray]]] = None


def _parse_header(f) -> Tuple[str, List[PLYElement]]:
    line = f.readline().strip()
    if line != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements: List[PLYElement] = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens or tokens[0] == "comment" or tokens[0] == "obj_info":
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            elements.append(PLYElement(tokens[1], int(tokens[2])))
        elif tokens[0] == "property":
            if tokens[1] == "list":
                elements[-1].list_properties.append(
                    (tokens[4], _PLY_DTYPES[tokens[2]], _PLY_DTYPES[tokens[3]])
                )
            else:
                elements[-1].properties.append((tokens[2], _PLY_DTYPES[tokens[1]]))
        elif tokens[0] == "end_header":
            break
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise ValueError(f"unsupported PLY format: {fmt}")
    return fmt, elements


def read_ply(path: str, preload: bool = True) -> Dict[str, PLYElement]:
    """Read every element of a PLY file into structured numpy arrays.

    ``preload`` mirrors the reference's whole-file memory-stream option
    (``ply_io.hpp:43-55``).
    """
    with open(path, "rb") as fh:
        f = io.BytesIO(fh.read()) if preload else fh
        fmt, elements = _parse_header(f)
        e = ">" if fmt == "binary_big_endian" else "<"
        for el in elements:
            dtype = np.dtype([(n, e + t) for n, t in el.properties])
            if el.list_properties:
                # Row-by-row parse (faces etc.); assumes fixed small counts.
                el.list_data = {n: [] for n, _, _ in el.list_properties}
                rows = []
                for _ in range(el.count):
                    if fmt == "ascii":
                        vals = f.readline().split()
                        pos = 0
                        row = []
                        for n, t in el.properties:
                            row.append(float(vals[pos])); pos += 1
                        for n, ct, vt in el.list_properties:
                            cnt = int(vals[pos]); pos += 1
                            el.list_data[n].append(
                                np.array(vals[pos:pos + cnt], dtype=vt))
                            pos += cnt
                        rows.append(tuple(row))
                    else:
                        row = []
                        for n, t in el.properties:
                            row.append(np.frombuffer(
                                f.read(np.dtype(t).itemsize), e + t)[0])
                        for n, ct, vt in el.list_properties:
                            cnt = int(np.frombuffer(
                                f.read(np.dtype(ct).itemsize), e + ct)[0])
                            el.list_data[n].append(np.frombuffer(
                                f.read(cnt * np.dtype(vt).itemsize), e + vt))
                        rows.append(tuple(row))
                el.data = np.array(rows, dtype=dtype) if el.properties else None
            else:
                if fmt == "ascii":
                    flat = np.loadtxt(
                        io.BytesIO(b"".join(f.readline() for _ in range(el.count))),
                        ndmin=2,
                    )
                    el.data = np.zeros(el.count, dtype)
                    for i, (n, _) in enumerate(el.properties):
                        el.data[n] = flat[:, i]
                else:
                    el.data = np.frombuffer(
                        f.read(el.count * dtype.itemsize), dtype, count=el.count
                    ).copy()
    return {el.name: el for el in elements}


def read_point_cloud(path: str):
    """Read points / normals / colors from a PLY ``vertex`` element.

    Returns ``(points f32 (N,3), normals or None, colors in [0,1] or None)`` —
    the payload of the reference's ``PointCloud::fromPLYFile``.

    Reads with the C++ codec (:mod:`cilantro_tpu_torch.native`). Where the
    codec does not build or cannot parse the file, it warns once with the
    reason and reads with the Python parser.
    """
    from ..native import ply_read_native

    try:
        return ply_read_native(path)
    except (RuntimeError, OSError, ValueError) as e:
        warnings.warn(
            f"read_point_cloud({path!r}): the C++ PLY codec failed "
            f"({type(e).__name__}: {e}); reading with the Python parser",
            RuntimeWarning, stacklevel=2,
        )
    return _read_point_cloud_python(path)


def _read_point_cloud_python(path: str):
    """:func:`read_point_cloud` by the Python parser alone."""
    elements = read_ply(path)
    if "vertex" not in elements:
        raise ValueError("PLY has no vertex element")
    v = elements["vertex"].data
    names = v.dtype.names
    pts = np.stack([v["x"], v["y"], v["z"]], -1).astype(np.float32)
    normals = None
    if all(k in names for k in ("nx", "ny", "nz")):
        normals = np.stack([v["nx"], v["ny"], v["nz"]], -1).astype(np.float32)
    colors = None
    if all(k in names for k in ("red", "green", "blue")):
        cols = np.stack([v["red"], v["green"], v["blue"]], -1)
        colors = (cols.astype(np.float32) / 255.0
                  if v.dtype["red"].kind == "u" else cols.astype(np.float32))
    return pts, normals, colors


def write_point_cloud(
    path: str,
    points: np.ndarray,
    normals: Optional[np.ndarray] = None,
    colors: Optional[np.ndarray] = None,
    binary: bool = True,
    big_endian: bool = False,
) -> None:
    """Write a point cloud PLY (reference ``PointCloud::toPLYFile``).
    ``big_endian`` selects ``binary_big_endian`` output (tinyply can emit
    either byte order; ignored for ascii)."""
    points = np.asarray(points, np.float32)
    n = len(points)
    e = ">" if (binary and big_endian) else "<"
    fields = [("x", e + "f4"), ("y", e + "f4"), ("z", e + "f4")]
    if normals is not None:
        fields += [("nx", e + "f4"), ("ny", e + "f4"), ("nz", e + "f4")]
    if colors is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    rec = np.zeros(n, np.dtype(fields))
    rec["x"], rec["y"], rec["z"] = points.T
    if normals is not None:
        normals = np.asarray(normals, np.float32)
        rec["nx"], rec["ny"], rec["nz"] = normals.T
    if colors is not None:
        colors = np.asarray(colors)
        if colors.dtype.kind == "f":
            colors = np.clip(colors * 255.0 + 0.5, 0, 255).astype(np.uint8)
        rec["red"], rec["green"], rec["blue"] = colors.T

    fmt = (
        "ascii" if not binary
        else "binary_big_endian" if big_endian
        else "binary_little_endian"
    )
    header = ["ply", f"format {fmt} 1.0", f"element vertex {n}"]
    for name, t in fields:
        header.append(f"property {_INV_DTYPES[t.lstrip('<>')]} {name}")
    header.append("end_header\n")
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        if binary:
            f.write(rec.tobytes())
        else:
            cols = [rec[name] for name, _ in fields]
            np.savetxt(f, np.column_stack([c.astype(np.float64) for c in cols]),
                       fmt="%.9g")
