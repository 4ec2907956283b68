"""PLY I/O of the port against the JAX package: the same clouds, drawn from
a seeded numpy generator, through both packages' writers and readers (the
Python parser and the C++ codec), in binary, ASCII and big-endian; a file
either package writes reads back identically in the other. Then
``PointCloud.to_ply`` / ``from_ply`` and the hostile and truncated files
``tests/test_native.py`` holds JAX's codec to."""

import warnings

import numpy as np
import pytest
import torch

from cilantro_tpu import native as jnative
from cilantro_tpu.core import containers as jcont
from cilantro_tpu.utils import ply_io as jply
from cilantro_tpu_torch import native as tnative
from cilantro_tpu_torch.core import containers as tcont
from cilantro_tpu_torch.utils import ply_io as tply

FORMATS = {
    "binary": dict(binary=True),
    "ascii": dict(binary=False),
    "big_endian": dict(binary=True, big_endian=True),
}


@pytest.fixture(scope="module", autouse=True)
def codec():
    """Build the port's codec once for the module (raises if g++ fails)."""
    tnative.build_host(("ply_codec",))


def _cloud(n=200, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    col = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return pts, nrm, col


def _u8(col):
    """The 8-bit colours both writers store."""
    return np.clip(col * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _native_colors(u8):
    """The C++ codec's colours: 8-bit values times float32(1/255), which
    can sit 1 ulp from the Python parser's ``u8 / 255``."""
    return u8.astype(np.float32) * np.float32(1.0 / 255.0)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_round_trip(tmp_path, fmt):
    """Points and normals come back exactly (float32 binary, ``%.9g``
    ASCII); colours as their 8-bit quantisation, by each reader's
    arithmetic."""
    pts, nrm, col = _cloud()
    p = str(tmp_path / "c.ply")
    tply.write_point_cloud(p, pts, nrm, col, **FORMATS[fmt])
    with open(p, "rb") as f:
        head = f.read(120)
    word = {"binary": b"binary_little_endian", "ascii": b"ascii", "big_endian": b"binary_big_endian"}[fmt]
    assert b"format " + word + b" 1.0" in head
    _same(tply.read_point_cloud(p), (pts, nrm, _native_colors(_u8(col))))
    el = tply.read_ply(p)["vertex"]
    assert el.count == len(pts) and el.data.dtype.names[:3] == ("x", "y", "z")
    np.testing.assert_array_equal(el.data["red"], _u8(col)[:, 0])


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_files_cross_between_packages(tmp_path, fmt):
    """Each package's writer gives the same bytes, and each package reads
    the other's file to identical arrays, by both readers."""
    pts, nrm, col = _cloud(seed=1)
    pj, pt = str(tmp_path / "jax.ply"), str(tmp_path / "torch.ply")
    jply.write_point_cloud(pj, pts, nrm, col, **FORMATS[fmt])
    tply.write_point_cloud(pt, pts, nrm, col, **FORMATS[fmt])
    assert open(pj, "rb").read() == open(pt, "rb").read()
    _same(tply.read_point_cloud(pj), jply.read_point_cloud(pt))
    _same(tnative.ply_read_native(pj), jnative.ply_read_native(pt))
    jel, tel = jply.read_ply(pt)["vertex"], tply.read_ply(pj)["vertex"]
    assert jel.data.dtype == tel.data.dtype
    np.testing.assert_array_equal(jel.data, tel.data)


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
def test_native_codec_crosses_between_packages(tmp_path, binary):
    """The C++ writers give the same bytes; each codec reads the other's."""
    pts, nrm, col = _cloud(seed=2)
    pj, pt = str(tmp_path / "jax.ply"), str(tmp_path / "torch.ply")
    assert jnative.ply_write_native(pj, pts, nrm, col, binary=binary)
    assert tnative.ply_write_native(pt, pts, nrm, col, binary=binary)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    _same(tnative.ply_read_native(pj), jnative.ply_read_native(pt))
    _same(tply.read_point_cloud(pj), jply.read_point_cloud(pt))


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_python_reader_matches_native_codec(tmp_path, fmt):
    pts, nrm, col = _cloud(seed=3)
    p = str(tmp_path / "c.ply")
    tply.write_point_cloud(p, pts, nrm, col, **FORMATS[fmt])
    v = tply.read_ply(p)["vertex"].data
    py_pts = np.stack([v["x"], v["y"], v["z"]], -1).astype(np.float32)
    py_nrm = np.stack([v["nx"], v["ny"], v["nz"]], -1).astype(np.float32)
    py_u8 = np.stack([v["red"], v["green"], v["blue"]], -1)
    _same(tnative.ply_read_native(p), (py_pts, py_nrm, _native_colors(py_u8)))
    np.testing.assert_array_equal(py_u8, _u8(col))


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
def test_point_cloud_to_ply_from_ply(tmp_path, binary):
    """``to_ply`` writes the valid slots in order (JAX's file, byte for
    byte); ``from_ply(capacity=...)`` pads as JAX's does."""
    pts, nrm, col = _cloud(n=64, seed=4)
    valid = np.random.default_rng(5).random(64) < 0.7
    tc = tcont.PointCloud(points=torch.as_tensor(pts), normals=torch.as_tensor(nrm),
                          colors=torch.as_tensor(col), valid=torch.as_tensor(valid))
    jc = jcont.PointCloud(points=pts, normals=nrm, colors=col, valid=valid)
    pt, pj = str(tmp_path / "torch.ply"), str(tmp_path / "jax.ply")
    tc.to_ply(pt, binary=binary)
    jc.to_ply(pj, binary=binary)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    for capacity in (None, 80):
        got = tcont.PointCloud.from_ply(pt, capacity=capacity, device="cpu")
        want = jcont.PointCloud.from_ply(pj, capacity=capacity)
        n = int(valid.sum())
        assert got.capacity == (n if capacity is None else capacity) == want.capacity
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        for a, b in ((got.points, want.points), (got.normals, want.normals), (got.colors, want.colors)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(got.points[:n].numpy(), pts[valid])


def test_from_ply_defaults_to_the_card(tmp_path, monkeypatch):
    pts, _, _ = _cloud(n=8)
    p = str(tmp_path / "c.ply")
    tply.write_point_cloud(p, pts)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcont.PointCloud.from_ply(p)


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


HEADER = "property float x\nproperty float y\nproperty float z\nend_header\n"


def _hostile(tmp_path, case):
    """The bad files of ``tests/test_native.py``: a vertex count far past
    the file, ASCII cut mid-number, a binary payload cut short."""
    p = str(tmp_path / f"{case}.ply")
    if case == "hostile_count":
        _write(p, "ply\nformat binary_little_endian 1.0\nelement vertex 99999999999\n" + HEADER)
    elif case == "ascii_truncated":
        _write(p, "ply\nformat ascii 1.0\nelement vertex 3\n" + HEADER + "1.0 2.0 3.0\n4.0 5.")
    else:
        pts = np.random.default_rng(6).standard_normal((50, 3)).astype(np.float32)
        assert tnative.ply_write_native(p, pts, binary=True)
        data = open(p, "rb").read()
        with open(p, "wb") as f:
            f.write(data[:-20])
    return p


@pytest.mark.parametrize("case", ["hostile_count", "ascii_truncated", "binary_truncated"])
def test_bad_files_raise_in_both_codecs(tmp_path, case):
    """Both packages' codecs refuse each file with ValueError; the port's
    ``read_point_cloud`` warns once that it falls back, then its Python
    parser refuses the file too, as JAX's silent fallback does."""
    p = _hostile(tmp_path, case)
    with pytest.raises(ValueError):
        jnative.ply_read_native(p)
    with pytest.raises(ValueError):
        tnative.ply_read_native(p)
    with pytest.raises(ValueError):
        jply.read_point_cloud(p)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        with pytest.raises(ValueError):
            tply.read_point_cloud(p)
    falls = [w for w in seen if "Python parser" in str(w.message)]
    assert len(falls) == 1 and "native PLY parse failed" in str(falls[0].message)


def test_fallback_when_the_codec_does_not_build(tmp_path, monkeypatch):
    """A codec that does not build makes ``ply_read_native`` raise with the
    compiler's message; ``read_point_cloud`` warns once with it and reads
    the file with the Python parser."""
    pts, nrm, col = _cloud(seed=7)
    p = str(tmp_path / "c.ply")
    tply.write_point_cloud(p, pts, nrm, col)
    want = tnative.ply_read_native(p)

    def broken(name):
        raise RuntimeError("host C++ build failed:\nply_codec: g++ exited 1\nerror: stub")

    monkeypatch.setattr(tnative, "load_host", broken)
    with pytest.raises(RuntimeError, match="exited 1"):
        tnative.ply_read_native(p)
    assert not tnative.native_available()
    with pytest.warns(RuntimeWarning, match="exited 1") as seen:
        got = tply.read_point_cloud(p)
    assert len(seen) == 1
    _same(got[:2], want[:2])
    np.testing.assert_array_equal(got[2], _u8(col).astype(np.float32) / 255.0)
