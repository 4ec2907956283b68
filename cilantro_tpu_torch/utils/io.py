"""Matrix I/O: raw binary and whitespace text (port of
``cilantro_tpu/utils/io.py``, the same numpy code: a file either package
writes reads back the same in the other).

Maps ``include/cilantro/utilities/io_utilities.hpp:10-90``: the reference
writes ``rows, cols`` as size_t followed by column-major data; here the
binary format is npy (self-describing, numpy-portable) plus a
reference-layout raw codec for byte-compatible exchange.
"""

from __future__ import annotations

import numpy as np


def write_matrix(path: str, matrix: np.ndarray, binary: bool = True) -> None:
    m = np.asarray(matrix)
    if binary:
        np.save(path if path.endswith(".npy") else path + ".npy", m)
    else:
        np.savetxt(path, m)


def read_matrix(path: str, binary: bool = True) -> np.ndarray:
    if binary:
        return np.load(path if path.endswith(".npy") else path + ".npy")
    return np.loadtxt(path)


def write_matrix_raw(path: str, matrix: np.ndarray) -> None:
    """Reference-layout raw binary: uint64 rows, uint64 cols, f32/f64
    column-major data (``io_utilities.hpp:10-50``)."""
    m = np.asarray(matrix)
    with open(path, "wb") as f:
        np.array(m.shape, np.uint64).tofile(f)
        m.T.tofile(f)  # column-major


def read_matrix_raw(path: str, dtype=np.float32) -> np.ndarray:
    with open(path, "rb") as f:
        rows, cols = np.fromfile(f, np.uint64, 2).astype(np.int64)
        data = np.fromfile(f, dtype, rows * cols)
    return data.reshape(cols, rows).T
