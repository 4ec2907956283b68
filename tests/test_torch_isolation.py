"""The port stands alone: importing it loads neither JAX nor anything of
``cilantro_tpu``, and its entry points never fall back to the CPU when
CUDA is asked for and absent."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises
import cilantro_tpu_torch
for mod in pkgutil.walk_packages(cilantro_tpu_torch.__path__, "cilantro_tpu_torch."):
    __import__(mod.name)
loaded = sorted(
    name for name, mod in sys.modules.items()
    if mod is not None and (name.split(".")[0] in ("jax", "jaxlib", "cilantro_tpu"))
)
print("LOADED", loaded)
"""


def test_import_loads_no_jax_and_no_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_cuda_default_raises_without_cuda(monkeypatch):
    from cilantro_tpu_torch import resolve_device
    from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
    from cilantro_tpu_torch.slam import driver, splat_fusion

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    depths = [np.ones((32, 40), np.float32)] * 2
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        splat_fusion.run_splat_sequence(depths, CameraIntrinsics.kinect_640())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.ate_rmse([np.eye(4)] * 3, [np.eye(4)] * 3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.run_fusion_sequence(depths, CameraIntrinsics.kinect_640())
    _, metrics = driver.run_fusion_sequence(depths, CameraIntrinsics.kinect_640(), device="cpu")
    assert metrics.frames == 2
    assert resolve_device("cpu") == torch.device("cpu")


def test_fusion_helpers_default_to_the_card(monkeypatch):
    """``empty_map`` and ``radial_weights`` build on the card unless asked
    for the CPU, as JAX's counterparts build on the default device."""
    from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
    from cilantro_tpu_torch.slam import fusion

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fusion.empty_map(16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fusion.radial_weights(4, 5, CameraIntrinsics.kinect_640())
    assert fusion.empty_map(16, device="cpu").data.device.type == "cpu"
    assert fusion.radial_weights(4, 5, CameraIntrinsics.kinect_640(), device="cpu").shape == (20,)


def test_icp_entry_points_raise_without_cuda(monkeypatch):
    from cilantro_tpu_torch import interop
    from cilantro_tpu_torch.core import containers
    from cilantro_tpu_torch.entry import entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
    pts = np.zeros((8, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        containers.from_numpy(pts)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        interop.point_cloud_from_numpy(pts)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        interop.fusion_map_from_numpy(np.zeros((16, 16), np.float32))
    # icp runs where its tensors lie: a CPU call needs no card.
    fwd, args = entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)


def test_neighbour_entry_points_raise_without_cuda(monkeypatch):
    from cilantro_tpu_torch import interop
    from cilantro_tpu_torch.core import containers

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    idx, dist, mask = np.zeros((4, 3), np.int32), np.zeros((4, 3), np.float32), np.ones((4, 3), bool)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        interop.neighborhoods_from_numpy(idx, dist, mask)
    nb = interop.neighborhoods_from_numpy(idx, dist, mask, device="cpu")
    assert nb.indices.device.type == "cpu" and nb.overflowed is None
    # Normals run where the cloud lies: a CPU cloud needs no card.
    cloud = containers.from_numpy(np.random.default_rng(0).random((64, 3), np.float32), device="cpu")
    assert cloud.with_normals_knn(8).normals.device.type == "cpu"


def test_warp_entry_points_raise_without_cuda(monkeypatch):
    """The warp entry points default to the card, as the rest of the port:
    without CUDA they raise, and run on the CPU only when asked."""
    from cilantro_tpu_torch import interop
    from cilantro_tpu_torch.registration import warp_field as tw
    from cilantro_tpu_torch.registration import warp_field_batched as twb

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    src = rng.uniform(-0.5, 0.5, (200, 3)).astype(np.float32)
    nodes = src[::20]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tw.build_deformation_graph(src, nodes)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tw.build_dense_graph(src)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tw.identity_warp(len(nodes))
    graph = tw.build_deformation_graph(src, nodes, device="cpu")
    assert graph.anchors.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tw.icp_warp_field(graph, src, src)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        twb.icp_warp_field_batched(graph, src, src[None])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        interop.deformation_graph_from_numpy(
            **{name: getattr(graph, name).numpy() for name in (
                "node_positions", "node_valid", "anchors", "anchor_weights", "arc_i", "arc_j",
                "arc_mask", "anchor_order", "anchor_sorted_ids", "arc_j_order", "arc_j_sorted")}
        )
    tf, it, _ = tw.icp_warp_field(graph, src, src, max_iterations=2, device="cpu")
    assert tf.linear.device.type == "cpu" and it.device.type == "cpu"
