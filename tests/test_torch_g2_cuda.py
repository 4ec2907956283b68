"""Slice G2 on the card: PLY files to and from card clouds, colour maps,
renders and live snapshots on the card against the same calls on the
CPU, the timers waiting for the card, and the profiling helpers' CUDA
records. The tests skip on a machine without a CUDA device. This file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_g2_cuda.py
"""

import json
import os
import pickle
from unittest import mock

import numpy as np
import pytest
import torch

from cilantro_tpu_torch.core.containers import PointCloud, from_numpy
from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
from cilantro_tpu_torch.core.transforms import Transform
from cilantro_tpu_torch.slam import run_fusion_sequence, synthetic_sequence
from cilantro_tpu_torch.slam.fusion import FusionMap
from cilantro_tpu_torch.utils import colormap, profiling, time_blocked
from cilantro_tpu_torch.utils.honest_timing import op_time
from cilantro_tpu_torch.viz import LiveMapViewer, render_cloud_image


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's card paths have no CPU mode")
    return torch.device("cuda")


def _cloud(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    col = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return pts, nrm, col


@pytest.mark.cuda
def test_ply_round_trip_through_the_card(cuda, tmp_path):
    pts, nrm, col = _cloud()
    cpu = from_numpy(pts, nrm, col, capacity=3200, device="cpu")
    card = from_numpy(pts, nrm, col, capacity=3200, device=cuda)
    pc, pg = str(tmp_path / "cpu.ply"), str(tmp_path / "card.ply")
    cpu.to_ply(pc)
    card.to_ply(pg)
    assert open(pc, "rb").read() == open(pg, "rb").read()
    back = PointCloud.from_ply(pg, capacity=3200)
    assert back.points.device.type == "cuda"
    for a, b in ((back.points, card.points), (back.normals, card.normals), (back.valid, card.valid)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["jet", "gray", "blue2red"])
def test_colormap_on_the_card_matches_the_cpu(cuda, name):
    vals = np.random.default_rng(1).standard_normal(10_000).astype(np.float32)
    got = colormap(torch.as_tensor(vals, device=cuda), name)
    assert got.device.type == "cuda"
    want = colormap(torch.as_tensor(vals), name)
    assert torch.allclose(got.cpu(), want, rtol=0, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("color_by", ["color", "normal", "z", "scalar"])
def test_render_on_the_card_matches_the_cpu(cuda, color_by):
    pts, nrm, col = _cloud(seed=2)
    cloud = from_numpy(pts, nrm, col, device=cuda)
    vals = torch.as_tensor(pts[:, 0], device=cuda)
    got = render_cloud_image(cloud, h=120, w=160, color_by=color_by, scalars=vals)
    want = render_cloud_image(cloud, h=120, w=160, color_by=color_by, scalars=vals, device="cpu")
    assert np.array_equal(got == 1.0, want == 1.0) and (got != 1.0).any()
    # Colours within 1e-6, but for z-buffer ties that float order decides.
    assert (np.abs(got - want).max(-1) > 1e-6).mean() <= 0.01


@pytest.mark.cuda
def test_live_snapshot_of_a_card_map(cuda, tmp_path):
    """The pool driver on the card with the viewer as its hook: each page
    equals the page of the same map and pose on the CPU."""
    h, w = 48, 64
    k = CameraIntrinsics.make(w * 525 / 640, w * 525 / 640, (w - 1) / 2, (h - 1) / 2)
    depths, _ = synthetic_sequence(6, h, w, k, seed=2)
    on_card = LiveMapViewer(str(tmp_path / "g.html"), every=2)
    on_cpu = LiveMapViewer(str(tmp_path / "c.html"), every=2)
    pages = []

    def hook(fi, fmap, pose):
        on_card(fi, fmap, pose)
        on_cpu(fi, FusionMap(data=fmap.data.cpu()), Transform(pose.linear.cpu(), pose.translation.cpu()))
        if fi % 2 == 0:
            pages.append(open(tmp_path / "g.html").read() == open(tmp_path / "c.html").read())

    run_fusion_sequence(depths, k, map_capacity=4 * h * w, on_frame=hook, device=cuda)
    assert pages == [True, True] and on_card.snapshots == 2


@pytest.mark.cuda
def test_timers_wait_for_the_card(cuda):
    """``time_blocked`` synchronises on a card result; ``op_time``'s two
    loops of a device-bound call grow with their length."""
    spin = lambda: torch.cuda._sleep(2_000_000) or torch.ones(1, device=cuda)  # noqa: E731
    with mock.patch.object(torch.cuda, "synchronize", wraps=torch.cuda.synchronize) as sync:
        out, seconds = time_blocked(lambda: {"r": [spin()]}, repeats=2)
    assert sync.call_count == 3 and seconds > 0 and out["r"][0].device.type == "cuda"
    res = op_time(lambda x: torch.cuda._sleep(2_000_000) or x, (torch.zeros(1, device=cuda),))
    assert res.linearity > 1.3 and res.per_iter_ms > 0


@pytest.mark.cuda
def test_profiling_records_the_card(cuda, tmp_path):
    x = torch.ones(512, 512, device=cuda)
    with profiling.trace(str(tmp_path / "t")):
        with profiling.annotate("g2_card_region"):
            (x @ x).sum().item()
    with open(os.path.join(tmp_path, "t", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "g2_card_region" for e in events)
    assert any(e.get("cat") == "kernel" for e in events)
    path = tmp_path / "mem.pickle"
    profiling.device_memory_profile(str(path))
    with open(path, "rb") as f:
        assert "segments" in pickle.load(f)
