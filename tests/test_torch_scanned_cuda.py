"""The CUDA ``project_to_rotation`` kernel against its plain PyTorch
version, and the scanned drivers' CUDA-graph replays on the card.

The kernel repeats the plain version's operations one IEEE rounding each,
so the two agree bit for bit (compared as int32 views). A replay must
equal the eager graph-form steps within 1e-5 (the captured cuBLAS calls
may sum in another order) and launch what one captured step records. A
whole-clip entry's graph kept from an earlier call must give the bits of
a fresh capture (nothing kept, as in a new process). The tests skip on a
machine without a CUDA device. This file imports neither
JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_scanned_cuda.py
"""

import contextlib

import numpy as np
import pytest
import torch

from cilantro_tpu_torch import native
from cilantro_tpu_torch.core import transforms as tt
from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
from cilantro_tpu_torch.slam import driver as td
from cilantro_tpu_torch.slam import scan as tscan
from cilantro_tpu_torch.slam import splat_fusion as tsf
from cilantro_tpu_torch.slam.fusion import FusionConfig


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _matrices(kind, n, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "near_identity":
        a = np.eye(3) + 1e-6 * rng.standard_normal((n, 3, 3))
    elif kind == "general":
        a = rng.standard_normal((n, 3, 3))
    elif kind == "scaled":  # Kabsch cross-covariances reach 1e4 and more
        a = 1e4 * rng.standard_normal((n, 3, 3))
    else:  # exact and tied entries
        a = rng.integers(-2, 3, size=(n, 3, 3)).astype(np.float64)
        a[0] = 0.0
    return a.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["near_identity", "general", "scaled", "small_integers"])
@pytest.mark.parametrize("n", [1, 127, 4099])
def test_rotation_kernel_matches_plain(cuda, kind, n):
    x = torch.from_numpy(_matrices(kind, n, seed=n)).to(cuda)
    before = native.launch_counts["project_to_rotation"]
    got = tt.project_to_rotation(x)
    torch.cuda.synchronize()
    assert native.launch_counts["project_to_rotation"] - before == 1
    want = tt.project_to_rotation_plain(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.isfinite(got).all()


@pytest.mark.cuda
def test_rotation_kernel_takes_views_and_batches(cuda):
    x = torch.from_numpy(_matrices("general", 24)).to(cuda)
    view = x.reshape(2, 12, 3, 3).transpose(-1, -2)  # not contiguous
    got = tt.project_to_rotation(view)
    assert got.shape == (2, 12, 3, 3)
    assert torch.equal(got.view(torch.int32), tt.project_to_rotation_plain(view).view(torch.int32))


@pytest.mark.cuda
def test_rotation_kernel_does_not_wait_on_the_host(cuda):
    x = torch.from_numpy(_matrices("general", 64)).to(cuda)
    tt.project_to_rotation(x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tt.project_to_rotation(x)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _eager_graph_form_splat(depths, k, cfg, dev):
    staged = [torch.as_tensor(d, device=dev) for d in depths]
    smap = tsf.init_splat_map(*tsf._frame_images(staged[0], k, *depths[0].shape), cfg)
    pose = tt.identity(3, device=dev)
    poses = [pose.matrix()]
    for d in staged[1:]:
        smap, pose = tsf.splat_fusion_step(smap, d, pose, k, cfg=cfg, loop="graph")
        poses.append(pose.matrix())
    return np.stack([p.cpu().numpy() for p in poses])


@pytest.mark.cuda
def test_scanned_splat_replays_the_graph_form(cuda):
    k = CameraIntrinsics.make(140.0, 140.0, 79.5, 63.5)
    depths, gt = td.synthetic_sequence(4, 128, 160, k, seed=0)
    cfg = tsf.SplatConfig(radius=2, margin=16)
    stats = {}
    _, poses, spf, launches = tsf.run_splat_sequence_scanned(depths, k, cfg=cfg, stats=stats)
    np.testing.assert_allclose(np.stack(poses), _eager_graph_form_splat(depths, k, cfg, cuda),
                               atol=1e-5, rtol=0)
    n = cfg.icp_iterations
    assert stats["launches_per_frame"] == dict(
        dict.fromkeys(native.launch_counts, 0),
        window_read_codes=n, splat_argmin2=1, flow_select_rows=1, project_to_rotation=n,
    )
    assert launches == [{"window_read_codes": n, "splat_argmin2": 1, "flow_select_rows": 1}] * 3
    assert spf > 0 and stats["device_seconds_per_frame"] > 0
    assert all(1 <= i <= n for i in stats["iterations"])
    assert td.ate_rmse(poses, gt) < 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_scanned_pool_replays_the_graph_form(cuda, stride):
    k = CameraIntrinsics.make(120.0, 120.0, 63.5, 47.5)
    depths, gt = td.synthetic_sequence(6, 96, 128, k, seed=0)
    cfg = FusionConfig(localize_stride=stride)
    stats = {}
    fmap, m = td.run_fusion_sequence_scanned(depths, k, map_capacity=4 * 96 * 128, cfg=cfg, stats=stats)
    _, loop = td.run_fusion_sequence(depths, k, map_capacity=4 * 96 * 128, cfg=cfg)
    np.testing.assert_allclose(np.stack(m.poses), np.stack(loop.poses), atol=1e-5, rtol=0)
    assert m.icp_iterations == loop.icp_iterations
    # A pool of 4·H·W rows takes the row-scatter update (no gather), so a
    # frame gathers once to integrate and once an ICP iteration; each ICP
    # iteration takes one GN step.
    assert stats["launches_per_frame"] == dict(dict.fromkeys(native.launch_counts, 0),
                                               coalesced_gather=1 + cfg.icp_iterations,
                                               project_to_rotation=cfg.icp_iterations,
                                               gn_step=cfg.icp_iterations)
    assert fmap.data.device.type == "cuda" and m.num_map_points == int(fmap.num_points())
    assert td.ate_rmse(m.poses, gt) < 0.01


def _card_calls(k, depths):
    """Each whole-clip entry on a small clip: its name and a call that
    returns its poses and map."""
    from cilantro_tpu_torch.slam.batched_fusion import run_batched_fusion_sequences

    h, w = depths[0].shape
    stack = np.stack(depths)

    def splat():
        smap, poses, _, _ = tsf.run_splat_sequence_scanned(
            depths, k, cfg=tsf.SplatConfig(radius=2, margin=16))
        return np.stack(poses), smap.rows

    def fusion():
        fmap, m = td.run_fusion_sequence_scanned(depths, k, map_capacity=4 * h * w)
        return np.stack(m.poses), fmap.data

    def batched():
        data, m = run_batched_fusion_sequences(np.stack([stack, stack[::-1]]), k,
                                               map_capacity=4 * h * w)
        return m.poses, data

    return {"cilantro.entry.splat_scanned": splat, "cilantro.entry.fusion_scanned": fusion,
            "cilantro.entry.batched_fusion": batched}


@pytest.mark.cuda
def test_entry_spans_stay_on_the_host(cuda):
    """With the CUDA activity on: each entry's first call with nothing
    kept holds one warm-up and one capture span and counts
    ``scan_graph_captured``, its second neither span and counts
    ``scan_graph_reused``; no device-side event carries a ``cilantro.``
    name or is a user annotation; results are bit for bit those of an
    untraced call."""
    from torch.profiler import ProfilerActivity, profile

    k = CameraIntrinsics.make(140.0, 140.0, 79.5, 63.5)
    depths, _ = td.synthetic_sequence(4, 128, 160, k, seed=0)
    calls = _card_calls(k, depths)
    plain = {name: call() for name, call in calls.items()}
    tscan.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = {name: [call(), call()] for name, call in calls.items()}
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    device = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert device, "the profiler recorded no device event"
    assert not [e.name() for e in device if e.name().startswith("cilantro.")]
    assert not [e.name() for e in device if e.is_user_annotation()]
    host = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
            if e.device_type() != torch.autograd.DeviceType.CUDA
            and e.name().startswith("cilantro.")]
    for name in calls:
        roots = sorted(e for e in host if e[0] == name)  # by start
        assert len(roots) == 2, name
        for r, captures in zip(roots, (1, 0)):
            inside = [e[0] for e in host if r[1] <= e[1] and e[2] <= r[2]]
            assert inside.count("cilantro.scan.warmup") == captures, name
            assert inside.count("cilantro.scan.capture") == captures, name
            assert inside.count("cilantro.count.scan_graph_captured=1") == captures, name
            assert inside.count("cilantro.count.scan_graph_reused=1") == 1 - captures, name
            assert inside.count("cilantro.scan.pass.untimed") == 1, name
            assert inside.count("cilantro.scan.pass.timed") == 3, name
            assert inside.count("cilantro.scan.step") == 4 * 3, name
        for poses, data in traced[name]:
            np.testing.assert_array_equal(poses, plain[name][0])
            assert torch.equal(data, plain[name][1]), name


K_SMALL = CameraIntrinsics.make(140.0, 140.0, 79.5, 63.5)


def _clip(seed, h=128, w=160, streams=None):
    """4 synthetic frames ``(F, H, W)``, or ``(B, F, H, W)`` from seeds
    ``seed, seed + 1, ...`` for the batched entry."""
    if streams is None:
        return np.stack(td.synthetic_sequence(4, h, w, K_SMALL, seed=seed)[0])
    return np.stack([_clip(seed + b, h, w) for b in range(streams)])


ROOTS = {"splat": "cilantro.entry.splat_scanned", "fusion": "cilantro.entry.fusion_scanned",
         "batched": "cilantro.entry.batched_fusion"}


def _entry(name, clip, **cfg):
    """One call of a whole-clip entry on ``clip``: ``(poses, map,
    iterations, launches a step)``."""
    from cilantro_tpu_torch.slam.batched_fusion import run_batched_fusion_sequences

    cap = 4 * clip.shape[-2] * clip.shape[-1]
    stats = {}
    if name == "splat":
        smap, poses, _, _ = tsf.run_splat_sequence_scanned(
            list(clip), K_SMALL, cfg=tsf.SplatConfig(radius=2, margin=16, **cfg), stats=stats)
        return np.stack(poses), smap.rows, stats["iterations"], stats["launches_per_frame"]
    if name == "fusion":
        fmap, m = td.run_fusion_sequence_scanned(list(clip), K_SMALL, map_capacity=cap,
                                                 cfg=FusionConfig(**cfg), stats=stats)
        return np.stack(m.poses), fmap.data, m.icp_iterations, stats["launches_per_frame"]
    data, m = run_batched_fusion_sequences(clip, K_SMALL, map_capacity=cap,
                                           cfg=FusionConfig(**cfg), stats=stats)
    return m.poses, data, stats["icp_iterations"], stats["launches_per_step"]


@contextlib.contextmanager
def _window(name, calls: list):
    """One profiler window (CPU and CUDA activity) over the block; after
    it, ``calls`` holds, for each call of ``name``'s entry in it, the
    names of the ``cilantro.`` host events inside its entry span. One
    window a test: some two dozen windows, each over entry calls that
    capture and replay graphs, left a later window in the process
    recording no kernel (``test_torch_g2_cuda.py``); 60 windows over
    plain kernels did not."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
        torch.cuda.synchronize()
    host = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() != torch.autograd.DeviceType.CUDA
            and e.name().startswith("cilantro.")]
    for r in sorted(e for e in host if e[0] == ROOTS[name]):
        calls.append([e[0] for e in host if r[1] <= e[1] and e[2] <= r[2]])


def _same(a, b):
    """Poses, map and iterations bit for bit, and equal launches."""
    np.testing.assert_array_equal(a[0].view(np.int32), b[0].view(np.int32))
    assert torch.equal(a[1].contiguous().view(torch.int32), b[1].contiguous().view(torch.int32))
    np.testing.assert_array_equal(np.asarray(a[2]), np.asarray(b[2]))
    assert a[3] == b[3]


def _captured(names):
    return (names.count("cilantro.count.scan_graph_captured=1") == 1
            and names.count("cilantro.scan.capture") == 1
            and names.count("cilantro.scan.warmup") == 1
            and "cilantro.count.scan_graph_reused=1" not in names)


def _reused(names):
    return (names.count("cilantro.count.scan_graph_reused=1") == 1
            and "cilantro.count.scan_graph_captured=1" not in names
            and "cilantro.scan.warmup" not in names and "cilantro.scan.capture" not in names)


def _streams(name):
    return 2 if name == "batched" else None


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["splat", "fusion", "batched"])
def test_kept_graph_matches_a_fresh_capture(cuda, name):
    """Clip A captures; clip B replays the kept graph (no warm-up or
    capture span, ``scan_graph_reused``); after ``clear`` clip B captures
    anew and gives the same bits and launches as the kept graph did."""
    tscan.clear()
    clip_b = _clip(10, streams=_streams(name))
    calls = []
    with _window(name, calls):
        _entry(name, _clip(0, streams=_streams(name)))
        kept = _entry(name, clip_b)
        tscan.clear()
        fresh = _entry(name, clip_b)
    assert len(calls) == 3
    assert _captured(calls[0]) and _reused(calls[1]) and _captured(calls[2])
    _same(kept, fresh)


@pytest.mark.cuda
@pytest.mark.parametrize("name,change", [
    ("splat", dict(cfg=dict(icp_iterations=4))), ("splat", dict(h=96, w=128)),
    ("fusion", dict(cfg=dict(localize_stride=2))), ("fusion", dict(h=96, w=128)),
    ("batched", dict(cfg=dict(localize_stride=2))), ("batched", dict(streams=3)),
])
def test_changed_key_captures_anew(cuda, name, change):
    """After a call on clip A, a call whose key differs (a configuration
    field, the frame shape, the batch size) captures anew, and gives the
    bits of the same call with nothing kept."""
    tscan.clear()
    clip = _clip(10, change.get("h", 128), change.get("w", 160),
                 change.get("streams", _streams(name)))
    cfg = change.get("cfg", {})
    calls = []
    with _window(name, calls):
        _entry(name, _clip(0, streams=_streams(name)))
        got = _entry(name, clip, **cfg)
        tscan.clear()
        fresh = _entry(name, clip, **cfg)
    assert len(calls) == 3 and all(_captured(c) for c in calls)
    _same(got, fresh)
