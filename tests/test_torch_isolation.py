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
sys.modules["cilantro_tpu"] = None  # and any import of the JAX package
import cilantro_tpu_torch
walked = []
for mod in pkgutil.walk_packages(cilantro_tpu_torch.__path__, "cilantro_tpu_torch."):
    __import__(mod.name)
    walked.append(mod.name)
loaded = sorted(
    name for name, mod in sys.modules.items()
    if mod is not None and (name.split(".")[0] in ("jax", "jaxlib", "cilantro_tpu"))
)
print("LOADED", loaded)
print("WALKED", " ".join(walked))
"""

# The modules of Slices G2 and H, each of which the probe must import.
G2_MODULES = (
    "native", "utils.io", "utils.colormap", "utils.timer", "utils.roofline", "utils.honest_timing",
    "utils.profiling", "utils.ply_io", "viz", "viz.interactive", "viz.offline", "viz.live",
    "parallel", "parallel.sharded", "parallel.sharded_fusion", "parallel.sharded_warp",
    "parallel.distributed", "parallel.collectives",
)
# The multi-rank tests' worker scripts: the ranks run the port alone.
_WORKER_PROBE = """
import sys
sys.modules["jax"] = None
sys.modules["cilantro_tpu"] = None
sys.path.insert(0, "tests")
import torch_parallel_ranks, torch_parallel_worker
torch_parallel_worker.small_ba()
loaded = sorted(
    name for name, mod in sys.modules.items()
    if mod is not None and (name.split(".")[0] in ("jax", "jaxlib", "cilantro_tpu"))
)
print("LOADED", loaded, sorted(torch_parallel_worker.SUITES))
"""


def test_import_loads_no_jax_and_no_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
    walked = set(out.stdout.split("WALKED", 1)[1].split())
    missing = {f"cilantro_tpu_torch.{m}" for m in G2_MODULES} - walked
    assert not missing, sorted(missing)


def test_worker_scripts_load_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _WORKER_PROBE], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED [] ['ba', 'desync', 'dryrun', 'fusion', 'icp', 'pipeline', 'warp']" in out.stdout, out.stdout


# Slice I: the examples and the multi-device dryrun run with JAX and the
# JAX package unimportable (their imports inside functions included).
_SLICE_I_PROBE = """
import contextlib, io, pkgutil, sys
sys.modules["jax"] = None
sys.modules["cilantro_tpu"] = None
import torch
torch.set_num_threads(1)  # the test run's workers share the cores
import cilantro_tpu_torch.examples as ex
from cilantro_tpu_torch.entry import dryrun_multichip
names = sorted(m.name for m in pkgutil.iter_modules(ex.__path__) if not m.name.startswith("_"))
for name in names:
    __import__(f"cilantro_tpu_torch.examples.{name}")
dryrun_multichip(1, device="cpu")
with contextlib.redirect_stdout(io.StringIO()):
    for name in ("convex_hull", "mds_and_pca", "mean_shift"):
        assert sys.modules[f"cilantro_tpu_torch.examples.{name}"].main(["--device", "cpu"]) == 0
loaded = sorted(
    name for name, mod in sys.modules.items()
    if mod is not None and (name.split(".")[0] in ("jax", "jaxlib", "cilantro_tpu"))
)
print("LOADED", loaded)
print("EXAMPLES", " ".join(names))
"""


def test_examples_and_dryrun_run_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _SLICE_I_PROBE], cwd=REPO, capture_output=True, text=True, timeout=180,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    assert "LOADED []" in out.stdout, out.stdout
    names = set(out.stdout.split("EXAMPLES", 1)[1].split())
    assert names == {p.stem for p in (REPO / "examples").glob("*.py")}, names

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


def test_slam_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The SLAM backend's entry points default to the card: without CUDA
    they raise, and run on the CPU only when asked."""
    from cilantro_tpu_torch import interop, slam
    from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
    from cilantro_tpu_torch.core.transforms import identity

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    k = CameraIntrinsics.make(20.0, 20.0, 7.5, 5.5)
    depths = [np.full((12, 16), 2.0, np.float32)] * 3
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        slam.run_slam(depths, k)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        slam.integrate_sequence(depths, [np.eye(4, dtype=np.float32)] * 3, k)
    poses = identity(batch_shape=(2,), device="cpu")
    problem = (np.zeros((1, 3), np.float32), [0, 1], [0, 0], np.zeros((2, 3), np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        slam.bundle_adjust(poses, *problem)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        interop.ba_problem_from_numpy(np.eye(3)[None], np.zeros((1, 3)), *problem)
    graph = slam.KeyframeGraph.empty()
    for f in range(2):
        slam.spawn_keyframe(graph, f, np.eye(4, dtype=np.float32), np.ones((8, 3), np.float32), None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graph.optimize()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        slam.detect_loop_closures(graph, min_separation=1)
    path = str(tmp_path / "ck.npz")
    slam.save_checkpoint(path, slam.empty_map(8, device="cpu"), [np.eye(4, dtype=np.float32)], 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        slam.load_checkpoint(path).fusion_map()
    assert slam.load_checkpoint(path).fusion_map(device="cpu").data.device.type == "cpu"
    refined, _ = graph.optimize(device="cpu")
    assert len(refined) == 2


def test_multi_stream_entry_points_raise_without_cuda(monkeypatch):
    """Batched and pipelined fusion default to the card: without CUDA they
    raise, and run on the CPU only when asked."""
    from cilantro_tpu_torch import slam
    from cilantro_tpu_torch.core.rgbd import CameraIntrinsics

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    k = CameraIntrinsics.make(20.0, 20.0, 7.5, 5.5)
    stacks = np.full((2, 2, 12, 16), 2.0, np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        slam.run_batched_fusion_sequences(stacks, k)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        slam.run_fusion_sequence_pipelined(list(stacks[0]), k)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        slam.make_pipeline_mesh()
    data, metrics = slam.run_batched_fusion_sequences(stacks, k, device="cpu")
    assert data.device.type == "cpu" and metrics.poses.shape == (2, 2, 4, 4)
    fmap, metrics = slam.run_fusion_sequence_pipelined(list(stacks[0]), k, device="cpu")
    assert fmap.data.device.type == "cpu" and metrics.frames == 2


def test_parallel_entry_points_raise_without_cuda(monkeypatch):
    """The mesh defaults to the card: without CUDA ``make_mesh`` raises
    before it makes a process group."""
    import torch.distributed as dist

    from cilantro_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    assert not dist.is_initialized()


def test_estimation_entry_points_raise_without_cuda(monkeypatch):
    """The estimation, clustering, MDS and spatial entry points default to
    the card for numpy input: without CUDA they raise, and run on the CPU
    only when asked or when handed CPU tensors."""
    from cilantro_tpu_torch import clustering, model_estimation, spatial
    from cilantro_tpu_torch.utils import mds  # the function the package re-exports

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.random.default_rng(0).random((64, 3)).astype(np.float32)
    calls = {
        "ransac_plane": lambda **kw: model_estimation.ransac_plane(None, pts, 0.01, num_hypotheses=4, **kw),
        "ransac_transform": lambda **kw: model_estimation.ransac_transform(None, pts, pts, 0.01,
                                                                           num_hypotheses=4, **kw),
        "kmeans": lambda **kw: clustering.kmeans(None, pts, 2, **kw),
        "mean_shift": lambda **kw: clustering.mean_shift(pts, 0.5, **kw),
        "spectral_clustering": lambda **kw: clustering.spectral_clustering(None, np.eye(12, dtype=np.float32),
                                                                           2, **kw),
        "mds": lambda **kw: mds(np.eye(5, dtype=np.float32), 2, **kw),
        "contains": lambda **kw: spatial.ConvexPolytope.from_points(pts[:8]).contains(pts, **kw),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
        out = call(device="cpu")
        leaf = out[0] if isinstance(out, tuple) else out
        tensor = leaf if isinstance(leaf, torch.Tensor) else next(
            v for v in vars(leaf).values() if isinstance(v, torch.Tensor))
        assert tensor.device.type == "cpu", name
    res = clustering.kmeans(torch.Generator(), torch.as_tensor(pts), 2)
    assert res.labels.device.type == "cpu"


def test_g2_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """PLY loading, colour maps of host arrays and the camera of a host
    cloud default to the card: without CUDA they raise, and run on the CPU
    when asked or when handed CPU tensors."""
    from cilantro_tpu_torch.core.containers import PointCloud
    from cilantro_tpu_torch.utils import colormap_jet, write_point_cloud
    from cilantro_tpu_torch.viz import auto_camera, render_cloud_image

    pts = np.random.default_rng(0).random((64, 3)).astype(np.float32) + [0, 0, 2]
    path = str(tmp_path / "c.ply")
    write_point_cloud(path, pts)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "from_ply": lambda **kw: PointCloud.from_ply(path, **kw).points,
        "colormap": lambda **kw: colormap_jet(pts[:, 2], **kw),
        "auto_camera": lambda **kw: auto_camera(pts, **kw).linear,
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
        assert call(device="cpu").device.type == "cpu", name
    cloud = PointCloud.from_ply(path, device="cpu")
    assert render_cloud_image(cloud, h=12, w=16).shape == (12, 16, 3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_cloud_image(cloud, h=12, w=16, device="cuda")
