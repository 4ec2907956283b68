"""The port's offline visualization against the JAX package on the CPU:
``render_cloud_image`` on a small cloud through both z-buffers, and the
PNG and artefact writers (matplotlib is optional; it is present here and
absent on the card's host)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilantro_tpu import viz as jviz
from cilantro_tpu.core import containers as jcont
from cilantro_tpu_torch import viz as tviz
from cilantro_tpu_torch.core import containers as tcont

MESH_VERTS = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
MESH_FACES = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], np.int64)


@pytest.mark.parametrize("color_by", ["color", "normal", "z", "scalar"])
def test_render_cloud_image_matches_jax(color_by):
    """The same small cloud through both z-buffers: the background exactly,
    colours within 1e-6."""
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 1, (1500, 3)).astype(np.float32)
    nrm = rng.standard_normal((1500, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    col = rng.uniform(0, 1, (1500, 3)).astype(np.float32)
    vals = rng.standard_normal(1500).astype(np.float32)
    jc = jcont.from_numpy(pts, nrm, col, capacity=1600)
    tc = tcont.from_numpy(pts, nrm, col, capacity=1600, device="cpu")
    kw = dict(h=60, w=80, color_by=color_by)
    want = jviz.render_cloud_image(jc, scalars=jnp.asarray(vals), **kw)
    got = tviz.render_cloud_image(tc, scalars=torch.as_tensor(vals), **kw)
    assert got.shape == want.shape == (60, 80, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got == 1.0, np.asarray(want) == 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got != 1.0).any()
    jpose, tpose = jviz.auto_camera(pts), tviz.auto_camera(torch.as_tensor(pts))
    np.testing.assert_array_equal(tpose.linear.numpy(), np.asarray(jpose.linear))
    np.testing.assert_array_equal(tpose.translation.numpy(), np.asarray(jpose.translation))


def test_png_artefacts(tmp_path):
    """The matplotlib writers (matplotlib is optional; it is present here)
    write PNGs, and ``dump_artifacts`` writes JAX's PLY and poses."""
    from cilantro_tpu_torch.correspondence.search import find_nn_correspondences
    from cilantro_tpu_torch.viz import offline

    rng = np.random.default_rng(3)
    pts = rng.uniform(-1, 1, (800, 3)).astype(np.float32)
    nrm = np.zeros_like(pts)
    nrm[:, 2] = 1.0
    poses = [np.eye(4, dtype=np.float32) for _ in range(4)]
    for i, p in enumerate(poses):
        p[:3, 3] = [0.1 * i, 0.0, 0.0]
    tcloud = tcont.from_numpy(pts, normals=nrm, device="cpu")
    tviz.dump_artifacts(str(tmp_path / "t"), tcloud, [torch.as_tensor(p) for p in poses],
                        gt_poses=poses, prefix="r")
    jviz.dump_artifacts(str(tmp_path / "j"), jcont.from_numpy(pts, normals=nrm), poses, prefix="r")
    for name in ("r_map.ply", "r_poses.npy"):
        assert open(tmp_path / "t" / name, "rb").read() == open(tmp_path / "j" / name, "rb").read(), name
    for name in ("r_map.png", "r_trajectory.png"):
        assert open(tmp_path / "t" / name, "rb").read(8) == b"\x89PNG\r\n\x1a\n", name
    tq = torch.as_tensor(pts[:200])
    corr = find_nn_correspondences(tq, tq + 0.01)
    offline.save_correspondences_png(str(tmp_path / "corr.png"), tq, tq + 0.01, corr, max_lines=40)
    offline.save_mesh_png(str(tmp_path / "mesh.png"), torch.as_tensor(MESH_VERTS), MESH_FACES)
    for name in ("corr.png", "mesh.png"):
        assert (tmp_path / name).stat().st_size > 1000, name
