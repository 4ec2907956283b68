"""The port's host C++ (the PLY codec and the four CPU baselines) against
the JAX package's: the port keeps byte-identical copies of the sources,
each baseline gives JAX's outputs bit for bit on the small inputs of
``tests/test_native.py`` (everything but the library's own timings), and a
source that does not compile raises with the compiler's message."""

import filecmp
from pathlib import Path

import numpy as np
import pytest

from cilantro_tpu import native as jnative
from cilantro_tpu_torch import native as tnative

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def host_libraries():
    """Build every host library of the port once for the module."""
    tnative.build_host()


def test_sources_are_byte_identical_copies():
    jsrc = REPO / "cilantro_tpu" / "native" / "src"
    names = sorted(p.name for p in jsrc.iterdir() if p.suffix in (".cpp", ".hpp"))
    assert names == sorted(p.name for p in tnative.HOST_CSRC.iterdir() if p.suffix in (".cpp", ".hpp"))
    assert sorted(f"{n}.cpp" for n in tnative.HOST_SOURCES) == [n for n in names if n.endswith(".cpp")]
    match, mismatch, errors = filecmp.cmpfiles(jsrc, tnative.HOST_CSRC, names, shallow=False)
    assert match == names and not mismatch and not errors


def _equal(got, want, timings):
    """Every output but the ``timings`` positions (the library's own
    clock) bit for bit."""
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if i in timings:
            assert a >= 0.0 and b >= 0.0
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.int32) if a.dtype == np.float32 else a,
                                          b.view(np.int32) if b.dtype == np.float32 else b)
        else:
            assert a == b


def _surface(n, rng):
    xy = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    z = 0.3 * np.sin(2.0 * xy[:, 0]) * np.cos(1.5 * xy[:, 1])
    dst = np.column_stack([xy, z]).astype(np.float32)
    dzdx = 0.6 * np.cos(2.0 * xy[:, 0]) * np.cos(1.5 * xy[:, 1])
    dzdy = -0.45 * np.sin(2.0 * xy[:, 0]) * np.sin(1.5 * xy[:, 1])
    nrm = np.column_stack([-dzdx, -dzdy, np.ones(n)]).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return dst, nrm


def test_baseline_icp_matches_jax():
    rng = np.random.default_rng(0)
    dst, nrm = _surface(5000, rng)
    ang = 0.02
    r = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    src = (dst - np.array([0.008, -0.005, 0.004], np.float32)) @ r
    kw = dict(max_iterations=30, max_corr_dist_sq=0.01, convergence_tol=1e-6)
    got = tnative.baseline_icp_native(src, dst, nrm, **kw)
    _equal(got, jnative.baseline_icp_native(src, dst, nrm, **kw), timings={2})
    assert got[1] > 0 and np.abs(got[0][:, :3] - r).max() < 2e-3


@pytest.mark.parametrize("exclude_self", [False, True])
def test_baseline_knn_matches_jax(exclude_self):
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, (2000, 3)).astype(np.float32)
    q = pts if exclude_self else rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    k = 4 if exclude_self else 5
    got = tnative.baseline_knn_native(pts, q, k, exclude_self=exclude_self)
    _equal(got, jnative.baseline_knn_native(pts, q, k, exclude_self=exclude_self), timings={2, 3})


def test_baseline_radius_matches_jax():
    pts = np.random.default_rng(2).random((3000, 3)).astype(np.float32)
    got = tnative.baseline_radius_native(pts, pts, 0.06, 8, exclude_self=True)
    _equal(got, jnative.baseline_radius_native(pts, pts, 0.06, 8, exclude_self=True), timings={3, 4})
    assert (got[2] > 0).any()


def test_baseline_fusion_matches_jax():
    from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
    from cilantro_tpu_torch.slam.driver import synthetic_sequence

    k = CameraIntrinsics.make(131.25, 131.25, 79.5, 59.5)
    depths, gt = synthetic_sequence(5, 120, 160, k, seed=3)
    stack = np.stack(depths).astype(np.float32)
    got = tnative.baseline_fusion_native(stack, 131.25, 131.25, 79.5, 59.5)
    _equal(got, jnative.baseline_fusion_native(stack, 131.25, 131.25, 79.5, 59.5), timings={1})
    np.testing.assert_allclose(got[0], np.stack(gt), atol=2e-3)


def test_baseline_warp_matches_jax():
    rng = np.random.default_rng(4)
    src = rng.uniform(-0.5, 0.5, (8000, 3)).astype(np.float32)
    src[:, 2] = 0.1 * np.sin(4.0 * src[:, 0])
    dst = src.copy()
    dst[:, 2] += 0.02 * np.sin(8.0 * src[:, 0])
    kw = dict(ctrl_res=0.1, max_outer=10, max_cg=100, point_weight=1.0, stiffness=20.0, max_corr_dist_sq=0.01)
    got = tnative.baseline_warp_native(src, dst, **kw)
    _equal(got, jnative.baseline_warp_native(src, dst, **kw), timings={3})
    assert got[2] > 20 and got[1] >= 1


def test_native_available_and_cache_key():
    """``native_available`` keeps JAX's meaning; a library's name carries
    the hash of its source, its headers and the flags."""
    assert tnative.native_available() and jnative.native_available()
    path = tnative.host_library_path("baseline_icp")
    assert path.exists() and path.parent == tnative.BUILD_DIR
    assert path.name.startswith("libbaseline_icp-") and path.suffix == ".so"


def test_failed_build_raises_with_the_compiler_message(tmp_path):
    (tmp_path / "broken.cpp").write_text('extern "C" int f() { return undeclared_name; }\n')
    (tmp_path / "fine.hpp").write_text("#pragma once\n")
    path = tnative.host_library_path("broken", tmp_path)
    with pytest.raises(RuntimeError, match="undeclared_name") as err:
        tnative.build_host(("broken",), tmp_path)
    assert "broken: g++ exited" in str(err.value)
    assert not path.exists()
    (tmp_path / "fine.hpp").write_text("#pragma once\n// edited\n")
    assert tnative.host_library_path("broken", tmp_path) != path  # headers are in the key
