"""The port's examples on the main paths (pool fusion, SLAM, splat fusion
and the batched warp, the non-rigid warp, rigid ICP at the examples'
synthetic cloud) on ``--device cpu`` at small sizes, each held to the
truth it prints: ATE and map size, the loop closing and the backend
correcting the drift, the batched warp's residual against the planted bend, the
recovered rigid transform. JAX's scripts render the same sequences but
their runs are held by the module tests of each path, so only the truth
is held here.

Sizes: 48×64 frames (3 for fusion and splat fusion, 48 for SLAM), 2,000
template points for the batched warp, 4,000 height-field points for the
rigid ICP (``test_torch_examples_clouds.py`` runs the non-rigid ICP);
one torch thread (``torch_examples_run``). Bounds: ATE below 1 mm for the
pool and splat runs (0.23 and 0.25 mm measured), SLAM's refined max
orientation error and ATE no worse than the odometry's (4.04° → 2.43°,
4.65 → 4.11 cm measured; at this size a loop closes, the bound of
``tests/test_slam_loop.py`` is set for 72×96), each batched warp
stream's median error below half its 20 mm bend, the rigid transform
within 1e-3 of the truth."""

import re

import numpy as np

import pytest

from torch_examples_run import line, numbers, one_torch_thread, run_port  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_fusion_tracks_and_writes_its_artifacts(tmp_path):
    out = run_port("fusion", "3", "--size", "48", "64", "--out", str(tmp_path))
    assert out.splitlines()[0] == "rendering synthetic sequence..."
    frames, _, ate_mm, points = numbers(line(out, "3 frames,"))
    assert frames == 3 and ate_mm < 1.0 and points > 0.9 * 48 * 64
    assert line(out, "artifacts in") == f"artifacts in {tmp_path}/"
    for name in ("fusion_map.ply", "fusion_poses.npy", "fusion_map.png"):
        assert (tmp_path / name).stat().st_size > 0, name
    assert np.load(tmp_path / "fusion_poses.npy").shape == (3, 4, 4)


def test_slam_closes_the_loop(tmp_path):
    out = run_port("slam", "--frames", "48", "--size", "48", "64", "--cache", str(tmp_path))
    keyframes, loops = numbers(line(out, "keyframes:"))
    assert keyframes >= 5 and loops >= 1
    yaw_odometry, yaw_refined = numbers(line(out, "max orientation error:"))
    assert yaw_refined < yaw_odometry
    ate_odometry, ate_refined = numbers(line(out, "ATE:"))
    assert ate_refined <= ate_odometry
    assert numbers(line(out, "rebuilt map:"))[0] > 48 * 64


def test_batched_serving_tracks_and_warps():
    out = run_port("batched_serving", "3", "--size", "48", "64", "--warp-points", "2000")
    assert line(out, "rendering 3-frame synthetic 64x48 sequence...")
    ate_mm = numbers(line(out, "splat fusion:").split("ATE")[1])[0]
    assert ate_mm < 1.0
    warp = line(out, "batched warp x4:")
    assert "converged [True, True, True, True]" in warp
    errs = [float(e) for e in re.findall(r"([\d.]+)mm", warp)]
    assert len(errs) == 4 and max(errs) < 10.0


def test_rigid_icp_recovers_the_transform_on_the_default_cloud_kind():
    out = run_port("rigid_icp", "--points", "4000")
    assert "points from a synthetic height field" in out.splitlines()[0]
    assert numbers(line(out, "max abs error:"))[0] < 1e-3
