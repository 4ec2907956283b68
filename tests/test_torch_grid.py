"""The port's point clouds and voxel grids (``cilantro_tpu_torch/core/``
``containers.py``, ``grid.py``) against ``cilantro_tpu/core/`` on the CPU.

Tolerances: sort orders, bin ids and counts are integer results and must
be equal; per-bin means within 1e-6 (both sum each bin in sorted order,
so they differ at most by float32 rounding).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cilantro_tpu.core import containers as jc
from cilantro_tpu.core import grid as jg
from cilantro_tpu.core.transforms import Transform as JTransform
from cilantro_tpu_torch import interop
from cilantro_tpu_torch.core import containers as tc
from cilantro_tpu_torch.core import grid as tg


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud(seed, n=3000, normals=True, colors=False, invalid=0.1):
    """A noisy wavy sheet at 1-2 m (RGBD-like density), normals facing the
    camera at the origin, a share of slots invalid at 1e30."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.3, 0.3, (n, 2))
    z = 1.5 + 0.05 * np.sin(10 * xy[:, 0]) * np.cos(8 * xy[:, 1])
    pts = np.column_stack([xy, z]).astype(np.float32)
    nrm = np.column_stack([
        -0.5 * np.cos(10 * xy[:, 0]) * np.cos(8 * xy[:, 1]),
        0.4 * np.sin(10 * xy[:, 0]) * np.sin(8 * xy[:, 1]),
        -np.ones(n),
    ])
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    valid = rng.random(n) >= invalid
    pts[~valid] = 1e30
    col = rng.random((n, 3)).astype(np.float32) if colors else None
    return pts, (nrm if normals else None), col, valid


def _both(pts, nrm, col, valid):
    jcloud = jc.PointCloud(
        points=jnp.asarray(pts),
        normals=None if nrm is None else jnp.asarray(nrm),
        colors=None if col is None else jnp.asarray(col),
        valid=jnp.asarray(valid),
    )
    return jcloud, interop.point_cloud_from_numpy(pts, nrm, col, valid, device="cpu")


def _assert_cloud_close(tcl, jcl, atol=1e-6):
    np.testing.assert_array_equal(tcl.valid.numpy(), np.asarray(jcl.valid))
    np.testing.assert_allclose(tcl.points.numpy(), np.asarray(jcl.points), rtol=0, atol=atol)
    for name in ("normals", "colors"):
        a, b = getattr(tcl, name), getattr(jcl, name)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol)


def test_build_grid_bins_matches_jax():
    pts, _, _, valid = _cloud(0)
    pts[::9] = pts[4]  # a crowded bin
    bj = jg.build_grid_bins(jnp.asarray(pts), 0.02, jnp.asarray(valid))
    bt = tg.build_grid_bins(_t(pts), 0.02, _t(valid))
    for name in ("order", "segment_ids", "bin_of_point", "counts", "num_bins"):
        np.testing.assert_array_equal(
            getattr(bt, name).numpy(), np.asarray(getattr(bj, name)), err_msg=name
        )
    ij, cj = jg.grid_bin_ids(jnp.asarray(pts), 0.05)
    it, ct = tg.grid_bin_ids(_t(pts), 0.05)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


@pytest.mark.parametrize(
    "normals,colors,min_points,capacity,bin_size",
    [
        (True, False, 1, None, 0.02),
        (True, True, 1, 300, 0.02),  # capacity cut: most occupied bins
        (False, True, 3, None, 0.03),
        (True, False, 2, 5000, 0.01),  # capacity above the size: no cut
    ],
)
def test_grid_downsample_matches_jax(normals, colors, min_points, capacity, bin_size):
    pts, nrm, col, valid = _cloud(1, normals=normals, colors=colors)
    jcl, tcl = _both(pts, nrm, col, valid)
    want = jg.grid_downsample(jcl, bin_size, min_points_in_bin=min_points, capacity=capacity)
    got = tg.grid_downsample(tcl, bin_size, min_points_in_bin=min_points, capacity=capacity)
    _assert_cloud_close(got, want)


def test_voxel_coords_match_jax_on_cell_borders():
    """Points on cell borders: a true division keeps them in JAX's cell."""
    b = 0.02
    pts = (np.arange(-50, 50, dtype=np.float32) * np.float32(b))[:, None].repeat(3, 1)
    np.testing.assert_array_equal(
        tg.voxel_coords(_t(pts), b).numpy(), np.asarray(jg.voxel_coords(jnp.asarray(pts), b))
    )


def test_point_cloud_ops_match_jax():
    pts, nrm, col, valid = _cloud(2, n=500, colors=True)
    jcl, tcl = _both(pts, nrm, col, valid)
    rng = np.random.default_rng(3)
    ang = 0.1
    r = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    t = np.float32([0.1, -0.2, 0.05])
    tf = interop.transform_from_numpy(r, t, device="cpu")
    _assert_cloud_close(tcl.transformed(tf), jcl.transformed(JTransform(jnp.asarray(r), jnp.asarray(t))))
    idx = rng.integers(0, 500, 50)
    _assert_cloud_close(tcl.select(_t(idx)), jcl.select(jnp.asarray(idx)))
    _assert_cloud_close(tcl.remove(_t(idx)), jcl.remove(jnp.asarray(idx)))
    bad = pts.copy()
    bad[7, 1] = np.nan
    jb, tb = _both(bad, nrm, col, valid)
    _assert_cloud_close(tb.remove_invalid(), jb.remove_invalid())
    assert int(tcl.num_valid()) == int(jcl.num_valid())
    assert tcl.capacity == 500 and tcl.dim == 3 and tcl.has_normals() and tcl.has_colors()


def test_from_numpy_compact_append_match_jax():
    pts, nrm, col, valid = _cloud(4, n=200, colors=True)
    jcl = jc.from_numpy(pts[:150], nrm[:150], capacity=256)
    tcl = tc.from_numpy(pts[:150], nrm[:150], capacity=256, device="cpu")
    _assert_cloud_close(tcl, jcl)
    _, t2 = _both(pts, None, col, valid)
    j2 = jc.PointCloud(points=jnp.asarray(pts), colors=jnp.asarray(col), valid=jnp.asarray(valid))
    _assert_cloud_close(tc.append(tcl, t2), jc.append(jcl, j2))
    _assert_cloud_close(tc.compact(t2), jc.compact(j2))
