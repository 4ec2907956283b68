#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``cilantro_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``
(``/usr/local/cuda`` or on ``PATH``). It imports nothing of JAX. Phases,
in order; any failure raises and exits non-zero without the final line:

1. build the CUDA kernels from ``cilantro_tpu_torch/csrc/`` (one ``nvcc``
   per source, all at once);
2. hold each kernel against its plain PyTorch version on the card at the
   shapes splat fusion gives it at 640×480 (bit for bit: they are pure
   selects), and time kernel and plain version (CUDA events, median of 25
   runs after warm-up, launches queued behind a sleep kernel so that host
   enqueue time is not counted) beside the byte bound at 3.35 TB/s;
3. run splat fusion, the headline pipeline, through its entry point on 16
   synthetic 640×480 frames (radius 4, margin 16): launch counts, ms/frame,
   frames/s, ATE against ground truth (< 2e-3 m); then a per-stage time
   split and a profiler window (informational);
4. run the first 4 frames through the same entry point on the CPU (the
   plain versions) and require the poses to agree within 1e-4 m / 1e-4 rad.

Every line of standard output before the last two is one JSON object. The
line before the last is the card's name and power limit as ``nvidia-smi``
gives them; the last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
RADIUS, MARGIN, LAYERS = 4, 16, 2
H, W = 480, 640
HM, WM = H + 2 * MARGIN, W + 2 * MARGIN  # the model grid: 512 x 672
FRAMES, CPU_FRAMES = 16, 4
REPS = 25


def emit(**record):
    print(json.dumps(record), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def device_ms(fn) -> float:
    """Median device time of ``fn`` over ``REPS`` runs, in ms. Each run is
    queued behind a sleep kernel longer than the host takes to enqueue it,
    so the events bracket device work only."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    cycles = int(max(2e6, 4 * host_s * 2e9))
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| (0 where the two are equal, infinities included)."""
    a64, b64 = a.double(), b.double()
    return float(torch.where(a64 == b64, 0.0, (a64 - b64).abs()).max())


def assert_same_bits(name, kernel_out, plain_out):
    for k, p in zip(kernel_out, plain_out):
        kb, pb = k.contiguous().view(torch.int32), p.contiguous().view(torch.int32)
        if not torch.equal(kb, pb):
            bad = int((kb != pb).sum())
            raise AssertionError(f"{name}: kernel and plain version differ at {bad} elements")


def kernel_checks(splat, dev):
    """Phase 2: each kernel against its plain version at main-path shapes."""
    rng = np.random.default_rng(0)
    r = RADIUS
    w2 = 2 * r + 1
    hp, wp = HM + 2 * r, WM + 2 * r

    def codes(shape, high):
        """Codes uniform in [0, high) with ~20% -1; on a (2R+1)-window grid
        the codes near the border reach into the pad."""
        c = rng.integers(0, high, size=shape).astype(np.int32)
        c[rng.random(shape) < 0.2] = -1
        return torch.from_numpy(c).to(dev)

    records = []

    # window_read_codes: a 7-channel frame broadcast to both layers.
    img = torch.from_numpy(
        rng.integers(-(2**31), 2**31 - 1, size=(1, 7, hp, wp), dtype=np.int64).astype(np.int32)
    ).to(dev).expand(LAYERS, -1, -1, -1)
    off = codes((LAYERS, HM, WM), w2 * w2)
    n_ok = int((off >= 0).sum())
    nbytes = off.numel() * 4 + LAYERS * 7 * HM * WM * 4 + min(7 * hp * wp, n_ok * 7) * 4
    records.append(dict(
        name="window_read_codes", replaces="cilantro_tpu/slam/splat.py:312",
        kernel=lambda: splat.window_read_codes(img, off, radius=r),
        plain=lambda: splat.window_read_codes_plain(img, off, r),
        nbytes=nbytes,
    ))

    # splat_argmin2: one stream, two layers, keys in [0.5, 3) m with ties.
    key = torch.from_numpy((0.5 + 2.5 * rng.random((1, LAYERS, hp, wp))).astype(np.float32))
    key[torch.from_numpy(rng.random(key.shape) < 0.1)] = 1.0
    key = key.to(dev)
    aoff = codes((1, LAYERS, hp, wp), w2 * w2)
    key = torch.where(aoff >= 0, key, float("inf"))
    n_ok = int((aoff >= 0).sum())
    nbytes = aoff.numel() * 4 + n_ok * 4 + 4 * HM * WM * 4
    records.append(dict(
        name="splat_argmin2", replaces="cilantro_tpu/slam/splat.py:107",
        kernel=lambda: splat.splat_argmin2(key, aoff, radius=r),
        plain=lambda: splat.splat_argmin2_plain(key, aoff, r),
        nbytes=nbytes,
    ))

    # flow_select_rows: winner and runner-up codes of one 8-channel map.
    rows = torch.from_numpy(
        rng.standard_normal((1, LAYERS, 8, hp, wp)).astype(np.float32)
    ).to(dev).expand(2, -1, -1, -1, -1)
    code = codes((2, HM, WM), LAYERS * w2 * w2)
    n_ok = int((code >= 0).sum())
    nbytes = code.numel() * 4 + 2 * 8 * HM * WM * 4 + min(LAYERS * 8 * hp * wp, n_ok * 8) * 4
    records.append(dict(
        name="flow_select_rows", replaces="cilantro_tpu/slam/splat.py:221",
        kernel=lambda: splat.flow_select_rows(rows, code, radius=r),
        plain=lambda: splat.flow_select_rows_plain(rows, code, r),
        nbytes=nbytes,
    ))

    out = []
    for rec in records:
        as_tuple = lambda x: x if isinstance(x, tuple) else (x,)  # noqa: E731
        k_out, p_out = as_tuple(rec["kernel"]()), as_tuple(rec["plain"]())
        torch.cuda.synchronize()
        assert_same_bits(rec["name"], k_out, p_out)
        err = max(max_abs_err(k, p) for k, p in zip(k_out, p_out))
        ms = device_ms(rec["kernel"])
        plain_ms = device_ms(rec["plain"])
        bound_ms = rec["nbytes"] / HBM_BYTES_PER_S * 1e3
        entry = dict(
            name=rec["name"], route="cuda", source="cilantro_tpu_torch/csrc/splat_kernels.cu",
            replaces=rec["replaces"], max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by="bytes", library_ms=None,
            bytes=rec["nbytes"],
        )
        emit(phase="kernel_vs_plain", tolerance="bit-exact", **entry)
        out.append(entry)
    return out


def rot_angle(a: np.ndarray, b: np.ndarray) -> float:
    """Angle (rad) between two rotations, from the skew part of a·bᵀ
    (well conditioned near 0, unlike the trace)."""
    d = a.astype(np.float64) @ b.astype(np.float64).T
    s = 0.5 * np.array([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0], d[1, 0] - d[0, 1]])
    return float(np.arcsin(min(1.0, np.linalg.norm(s))))


def stage_split(sf, depths, k, cfg, dev, frames=6):
    """Per-stage host time of one frame (frame prep, localize, integrate),
    each stage ended with a synchronise: the layers' share of a frame."""
    d = [torch.as_tensor(x, device=dev) for x in depths[: frames + 1]]
    f0 = sf._frame_images(d[0], k, H, W)
    smap = sf.init_splat_map(*f0, cfg)
    pose = sf.identity(3, device=dev)
    split = {"frame_prep": [], "localize": [], "integrate": []}
    for depth in d[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = sf._frame_images(depth, k, H, W)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pose = sf.splat_localize(smap, *f, pose, k, cfg=cfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        smap = sf.splat_integrate(smap, *f, pose, k, cfg=cfg)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for name, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
            split[name].append(dt * 1e3)
    # The first frame initialises cuBLAS/cuSOLVER: report the median of the rest.
    return {name: statistics.median(v[1:]) for name, v in split.items()}


def profile_window(sf, depths, k, cfg, dev, ms_per_frame, frames=6):
    """Device kernel time per frame and the kernels that take it, over
    ``frames`` steady frames (torch.profiler), beside the unprofiled
    ms/frame: the device's busy and idle share. Informational: a profiler
    that sees no device time reports "not measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    d = [torch.as_tensor(x, device=dev) for x in depths[: frames + 2]]
    smap = sf.init_splat_map(*sf._frame_images(d[0], k, H, W), cfg)
    smap, pose = sf.splat_fusion_step(smap, d[1], sf.identity(3, device=dev), k, cfg=cfg)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for depth in d[2:]:
            smap, pose = sf.splat_fusion_step(smap, depth, pose, k, cfg=cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    n = len(d) - 2
    rows = sorted(
        ((evt.self_device_time_total, evt.key, evt.count) for evt in prof.key_averages()
         if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0),
        reverse=True,
    )
    busy_ms = sum(r[0] for r in rows) / 1e3 / n
    if busy_ms == 0:
        return {"device_busy": "not measured"}
    return {
        "frames": n,
        "device_kernel_ms_per_frame": busy_ms,
        "kernel_launches_per_frame": sum(r[2] for r in rows) / n,
        "wall_ms_per_frame_under_profiler": wall_ms / n,
        "ms_per_frame_unprofiled": ms_per_frame,
        "device_idle_share": 1.0 - busy_ms / ms_per_frame,
        "top_kernels": [
            {"kernel": key[:90], "ms_per_frame": us / 1e3 / n, "launches_per_frame": c / n}
            for us, key, c in rows[:12]
        ],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cilantro_tpu_torch import native
    from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
    from cilantro_tpu_torch.slam import splat
    from cilantro_tpu_torch.slam import splat_fusion as sf
    from cilantro_tpu_torch.slam.driver import ate_rmse, synthetic_sequence

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    # 1. Build.
    t0 = time.perf_counter()
    logs = native.build()
    build_s = time.perf_counter() - t0
    emit(phase="build", seconds=build_s, sources=list(native.SOURCES),
         compiled=sorted(logs), card=card, torch=torch.__version__, cuda=torch.version.cuda)
    for name, log in logs.items():
        emit(phase="build_log", source=name,
             ptxas=[ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln])

    # 2. Kernel vs plain on the card.
    kernels = kernel_checks(splat, dev)

    # 3. The main path: splat fusion on 16 frames of 640x480.
    k = CameraIntrinsics.kinect_640()
    cfg = sf.SplatConfig(radius=RADIUS, margin=MARGIN)
    t0 = time.perf_counter()
    depths, gt = synthetic_sequence(FRAMES, H, W, k, seed=0)
    emit(phase="input", frames=FRAMES, height=H, width=W, render_s=time.perf_counter() - t0)

    splat.reset_launch_counts()
    smap, poses, spf, per_frame = sf.run_splat_sequence(depths, k, cfg=cfg, device="cuda")
    launches = dict(splat.launch_counts)
    ate = ate_rmse(poses, gt, device="cuda")
    pts, nrm, conf = sf.extract_cloud(smap)
    fused = FRAMES - 1
    if launches["splat_argmin2"] != fused or launches["flow_select_rows"] != fused:
        raise AssertionError(f"main path launches {launches}: want {fused} argmin2 and select rows")
    if launches["window_read_codes"] < fused:
        raise AssertionError(f"main path launches {launches}: want >= {fused} window reads")
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if not ate < 2e-3:
        raise AssertionError(f"ATE {ate} m not below 2e-3 m")
    if not (len(pts) > 0.5 * H * W and np.isfinite(pts).all() and np.isfinite(nrm).all()):
        raise AssertionError(f"map has {len(pts)} live surfels or non-finite values")
    # A second run of the same sequence: the spread of the host-clock rate.
    _, poses2, spf2, _ = sf.run_splat_sequence(depths, k, cfg=cfg, device="cuda")
    if not np.allclose(np.stack(poses), np.stack(poses2), atol=1e-5):
        raise AssertionError("two runs of the main path disagree")
    emit(
        phase="main_path", pipeline="splat", frames=FRAMES, height=H, width=W,
        radius=RADIUS, margin=MARGIN, launches=launches,
        window_reads_per_frame=[f["window_read_codes"] for f in per_frame],
        ms_per_frame=spf * 1e3, frames_per_s=1.0 / spf,
        ms_per_frame_repeat=spf2 * 1e3, frames_per_s_repeat=1.0 / spf2,
        ate_m=ate, live_surfels=len(pts), card=card,
    )
    emit(phase="stage_split_ms_per_frame", card=card, **stage_split(sf, depths, k, cfg, dev))
    try:
        emit(phase="profile", card=card, **profile_window(sf, depths, k, cfg, dev, spf2 * 1e3))
    except Exception as e:  # informational phase: report and go on
        emit(phase="profile", device_busy="not measured", error=f"{type(e).__name__}: {e}")

    # 4. Card vs CPU (plain versions) on the first frames.
    _, cpu_poses, _, cpu_launches = sf.run_splat_sequence(
        depths[:CPU_FRAMES], k, cfg=cfg, device="cpu"
    )
    if any(sum(f.values()) for f in cpu_launches):
        raise AssertionError("the CPU run launched a kernel")
    dt = max(float(np.abs(a[:3, 3] - b[:3, 3]).max()) for a, b in zip(poses, cpu_poses))
    dr = max(rot_angle(a[:3, :3], b[:3, :3]) for a, b in zip(poses, cpu_poses))
    emit(phase="card_vs_cpu", frames=CPU_FRAMES, max_translation_diff_m=dt, max_rotation_diff_rad=dr)
    if not (dt < 1e-4 and dr < 1e-4):
        raise AssertionError(f"card and CPU poses differ by {dt} m / {dr} rad")

    # 5. The kernels line, 6. the card, 7. the result.
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
