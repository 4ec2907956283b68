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
   plain versions) and require the poses to agree within 1e-4 m / 1e-4 rad;
5. hold each nn1 kernel against its plain version on the card, bit for bit:
   the fused kernel at 4096 × 4096 (the ``entry()`` pair) and 32768 × 32768
   (the coarse ICP level), the compact and masked kernels at the tile pairs
   of the first full-resolution pass of the 640×480 pair, and the compact
   wrapper with a budget one short of the survivors (its masked fallback);
   each timed as in phase 2 beside its arithmetic bound (D + 2 products,
   D + 1 sums and a compare per visited pair of D-dimensional points, at
   67 TFLOP/s) and, for the fused kernel, ``torch.cdist`` + ``min`` as a
   two-call yardstick;
6. rigid ICP, the second main path: ``icp_multires`` registers frame 1 of
   the sequence onto frame 0 (307,200 points each) with the JAX bench's
   settings; launches per level (the compact kernel must run on both),
   iterations, ms by the host clock after a warm-up run, the error against
   the true relative pose beside that pose's size (< 5e-4 m and < 1e-4 rad,
   well inside the 5 mm and 4e-4 rad the frames are apart) and a profiler
   window;
7. ``icp`` with the ``entry()`` settings (a 0.5 m gate) on the same pair:
   more tile pairs survive than the budget holds, so the masked kernel runs;
8. ``entry()`` on the card: the fused kernel must run, and the toy pair's
   transform must come out within 5e-3 m and 5e-3 rad of the one that made
   it (0.027 m and 0.05 rad; the 10 iterations stop short of convergence);
9. ``icp_multires`` on a 160×120 pair on the card and on the CPU (the plain
   versions, pruned as on the card), agreeing within 1e-4 m / 1e-4 rad.

Each kernel's launch count in the kernels line comes from the path that
runs it (counts set to 0 just before that path and read just after):
splat fusion for the splat kernels, phase 6 for the compact kernel, phase
7 for the masked one, phase 8 for the fused one.

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
F32_OPS_PER_S = 67e12  # H100 SXM float32 rate off the tensor cores
BENCH_LEVELS = ((0.02, 10, 32768, 0.0064), (None, 3, None, 0.01))  # bench.py:194
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


def profile_once(run, ms_unprofiled, runs=1):
    """Device kernel time of ``run`` (torch.profiler), which does ``runs``
    units of work (frames, registrations), per unit and beside the
    unprofiled host time of one: the device's busy and idle share.
    Informational: a profiler that sees no device time reports "not
    measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(
        ((evt.self_device_time_total, evt.key, evt.count) for evt in prof.key_averages()
         if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0),
        reverse=True,
    )
    busy_ms = sum(r[0] for r in rows) / 1e3 / runs
    if busy_ms == 0:
        return {"device_busy": "not measured"}
    return {
        "runs": runs,
        "device_kernel_ms": busy_ms,
        "kernel_launches": sum(r[2] for r in rows) / runs,
        "wall_ms_under_profiler": wall_ms / runs,
        "ms_unprofiled": ms_unprofiled,
        "device_idle_share": 1.0 - busy_ms / ms_unprofiled,
        "top_kernels": [
            {"kernel": key[:90], "ms": us / 1e3 / runs, "launches": c / runs}
            for us, key, c in rows[:12]
        ],
    }


def profile_window(sf, depths, k, cfg, dev, ms_per_frame, frames=6):
    """:func:`profile_once` over ``frames`` steady frames of splat fusion,
    per frame."""
    d = [torch.as_tensor(x, device=dev) for x in depths[: frames + 2]]
    smap = sf.init_splat_map(*sf._frame_images(d[0], k, H, W), cfg)
    smap, pose = sf.splat_fusion_step(smap, d[1], sf.identity(3, device=dev), k, cfg=cfg)
    state = {"smap": smap, "pose": pose}

    def run():
        for depth in d[2:]:
            state["smap"], state["pose"] = sf.splat_fusion_step(
                state["smap"], depth, state["pose"], k, cfg=cfg
            )

    return profile_once(run, ms_per_frame, runs=len(d) - 2)


# ---------------------------------------------------------------------------
# Rigid ICP and its nn1 kernels.
# ---------------------------------------------------------------------------


def nn1_bound(pairs: int, nbytes: int, dim: int = 3):
    """Least time for ``pairs`` visited (query, key) pairs of ``dim``-D
    points: the larger of the arithmetic and the bytes (inputs read once,
    outputs written once). The function needs dim + 2 products, dim + 1
    sums and a compare per pair; the published float32 rate counts an FMA
    as two operations, so this is the time of a kernel that fuses every
    product into a sum (the port's kernels issue no FMA)."""
    ops_ms = pairs * (2 * dim + 4) / F32_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def frame_clouds(depth, k, dev):
    from cilantro_tpu_torch.core.rgbd import depth_to_points_normals

    return depth_to_points_normals(torch.as_tensor(depth, device=dev), k)


def coarse_clouds(src, dst, level):
    """The clouds ``icp_multires`` registers at a downsampled level."""
    from cilantro_tpu_torch.core.containers import PointCloud
    from cilantro_tpu_torch.core.grid import grid_downsample

    bin_size, _, capacity, _ = level
    (sp, _, sv), (dp, dn, dv) = src, dst
    sc = grid_downsample(PointCloud(points=sp, valid=sv), bin_size, capacity=capacity)
    dc = grid_downsample(PointCloud(points=dp, normals=dn, valid=dv), bin_size, capacity=capacity)
    return (sc.points, None, sc.valid), (dc.points, dc.normals, dc.valid)


def first_pass(nn, src, dst, mcd):
    """The augmented operands and tile pairs of the first nn1 pass of
    ``icp`` (identity start) on ``src`` → ``dst``."""
    (sp, _, sv), (dp, _, dv) = src, dst
    plan = nn.maybe_make_nn1_prune_plan(dp, mcd, sp, key_valid=dv, query_valid=sv)
    if plan is None:
        raise AssertionError("the first pass of the main path is not pruned")
    qs, within, budget = nn.prune_mask(sp, plan)
    qp = nn._augment_queries(qs, plan.tile_q)
    return qp, plan.kp, within, budget, plan.tile_q, plan.tile_m


def nn1_kernel_checks(nn, pair, coarse, entry_inputs):
    """Phase 5: each nn1 kernel against its plain version, timed."""
    out = {}

    def record(name, shape, kernel, plain, pairs, nbytes, library=None, **extra):
        k_out, p_out = kernel(), plain()
        torch.cuda.synchronize()
        assert_same_bits(name, k_out, p_out)
        err = max(max_abs_err(a, b) for a, b in zip(k_out, p_out))
        bound_ms, bound_by = nn1_bound(pairs, nbytes)
        entry = dict(
            name=name, route="cuda", source="cilantro_tpu_torch/csrc/nn1_kernels.cu",
            replaces=REPLACES[name], max_abs_err=err, ms=device_ms(kernel),
            plain_ms=device_ms(plain), bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None if library is None else device_ms(library),
            pairs=pairs, bytes=nbytes,
        )
        emit(phase="nn1_kernel_vs_plain", tolerance="bit-exact", shape=shape, **entry, **extra)
        return entry

    # Fused: the entry pair (its main-path shape), then the coarse level's size.
    for label, (q, kk, kv) in (
        ("4096x4096", (entry_inputs[0], entry_inputs[1], None)),
        ("32768x32768", (coarse[0][0], coarse[1][0], coarse[1][2])),
    ):
        qp, kp = nn._augment(q, kk, kv, nn._BLOCK_Q, 1)  # as nn1_fused pads them
        entry = record(
            "nn1_fused", label, lambda: nn.fused_rows(qp, kp), lambda: nn.fused_rows_plain(qp, kp),
            q.shape[0] * kk.shape[0], (qp.numel() + kp.numel()) * 4 + qp.shape[0] * 8,
            library=lambda: torch.cdist(q, kk).min(dim=1),
            library_is="torch.cdist + min over the same clouds (two calls, a yardstick; the port never calls it)",
        )
        out.setdefault("nn1_fused", entry)

    # Compact and masked: the first full-resolution pass of the main path.
    src, dst = pair
    qp, kp, within, budget, tq, tm = first_pass(nn, src, dst, BENCH_LEVELS[1][3])
    survivors = int(within.sum())
    qt, kt, fl = nn._compact_list(within, budget)
    pairs = survivors * tq * tm
    io_bytes = (qp.numel() + kp.numel()) * 4 + qp.shape[0] * 8
    shape = f"{qp.shape[0]}x{kp.shape[0]}, tiles {tq}x{tm}, {survivors} of {within.numel()} pairs"
    out["nn1_compact"] = record(
        "nn1_compact", shape,
        lambda: nn.compact_rows(qp, kp, qt, kt, fl, tile_q=tq, tile_m=tm),
        lambda: nn.compact_rows_plain(qp, kp, qt, kt, fl, tq, tm),
        pairs, io_bytes + 3 * 4 * budget, budget=budget,
    )
    mask = within.to(torch.int32)
    out["nn1_masked"] = record(
        "nn1_masked", shape,
        lambda: nn.masked_rows(qp, kp, mask, tile_q=tq, tile_m=tm),
        lambda: nn.masked_rows_plain(qp, kp, mask, tq, tm),
        pairs, io_bytes + mask.numel() * 4,
    )
    # The compact wrapper's fallback: a budget one short of the survivors.
    before = dict(nn.launch_counts)
    k_out = nn._nn1_compact(qp, kp, within, budget=survivors - 1, tile_q=tq, tile_m=tm)
    torch.cuda.synchronize()
    routed = {n: nn.launch_counts[n] - before[n] for n in before}
    if routed != {"nn1_fused": 0, "nn1_masked": 1, "nn1_compact": 0}:
        raise AssertionError(f"the over-budget compact call launched {routed}")
    assert_same_bits("nn1_compact fallback", [t.reshape(-1) for t in k_out],
                     nn.masked_rows_plain(qp, kp, mask, tq, tm))
    emit(phase="nn1_compact_fallback", budget=survivors - 1, survivors=survivors,
         launches=routed, tolerance="bit-exact", max_abs_err=0.0)
    return out


def gt_error(linear, translation, rel):
    """Translation (m) and rotation (rad) error of an estimate against the
    true relative pose ``rel`` (4×4)."""
    dt = float(np.linalg.norm(translation.cpu().numpy() - rel[:3, 3]))
    return dt, rot_angle(linear.cpu().numpy(), rel[:3, :3])


def icp_main_path(nn, icp_mod, pair, rel, card):
    """Phase 6: ``icp_multires`` on the 640×480 pair with the bench's
    settings; returns the launches of the timed run. Each level is one
    ``icp`` call, so wrapping ``icp`` snapshots the counts per level."""
    from unittest import mock

    (sp, _, sv), (dp, dn, dv) = pair

    def run():
        return icp_mod.icp_multires(
            sp, dp, dst_normals=dn, src_valid=sv, dst_valid=dv, metric="combined",
            convergence_tol=1e-4, levels=BENCH_LEVELS,
        )

    run()  # warm-up: cuBLAS / cuSOLVER handles, allocator
    torch.cuda.synchronize()
    snaps, iterations = [], []
    level_icp = icp_mod.icp

    def counted_icp(*args, **kwargs):
        snaps.append(dict(nn.launch_counts))
        res = level_icp(*args, **kwargs)
        iterations.append(int(res.iterations))
        return res

    nn.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(icp_mod, "icp", counted_icp):
        res = run()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    snaps.append(dict(nn.launch_counts))
    per_level = [{k: b[k] - a[k] for k in a} for a, b in zip(snaps, snaps[1:])]
    launches = dict(nn.launch_counts)
    if any(lv["nn1_compact"] == 0 for lv in per_level):
        raise AssertionError(f"the compact kernel did not run on every level: {per_level}")
    dt, dr = gt_error(res.transform.linear, res.transform.translation, rel)
    true_t, true_r = gt_error(torch.eye(3), torch.zeros(3), rel)  # the motion itself
    if not (dt < 5e-4 and dr < 1e-4):
        raise AssertionError(
            f"relative pose off by {dt} m / {dr} rad; the frames are {true_t} m / {true_r} rad apart"
        )
    t0 = time.perf_counter()
    res2 = run()
    torch.cuda.synchronize()
    ms2 = (time.perf_counter() - t0) * 1e3
    repeat_diff = max(
        float((res.transform.linear - res2.transform.linear).abs().max()),
        float((res.transform.translation - res2.transform.translation).abs().max()),
    )
    if not repeat_diff < 1e-5:
        raise AssertionError(f"two runs of the ICP main path differ by {repeat_diff}")
    emit(
        phase="icp_main_path", pipeline="icp_multires", points=int(sp.shape[0]),
        levels=[list(lv) for lv in BENCH_LEVELS], launches=launches,
        launches_per_level=per_level,
        iterations_per_level=iterations,
        ms=ms, ms_repeat=ms2, repeat_max_diff=repeat_diff,
        translation_error_m=dt, rotation_error_rad=dr,
        true_translation_m=true_t, true_rotation_rad=true_r,
        correspondences_last=int(res.num_correspondences), card=card,
    )
    try:
        emit(phase="icp_profile", card=card, **profile_once(run, ms2))
    except Exception as e:  # informational phase: report and go on
        emit(phase="icp_profile", device_busy="not measured", error=f"{type(e).__name__}: {e}")
    return launches


def wide_gate_path(nn, icp_mod, pair, rel):
    """Phase 7: ``icp`` with the ``entry()`` settings (0.5 m gate) on the
    640×480 pair: the survivors overflow the budget, each pass is masked."""
    (sp, _, sv), (dp, dn, dv) = pair
    nn.reset_launch_counts()
    t0 = time.perf_counter()
    res = icp_mod.icp(
        sp, dp, dst_normals=dn, src_valid=sv, dst_valid=dv, metric="combined",
        point_weight=0.3, max_corr_dist_sq=0.25, max_iterations=3,
    )
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(nn.launch_counts)
    if launches["nn1_masked"] == 0:
        raise AssertionError(f"the wide-gate path did not run the masked kernel: {launches}")
    dt, dr = gt_error(res.transform.linear, res.transform.translation, rel)
    if not (np.isfinite(dt) and np.isfinite(dr)):
        raise AssertionError("the wide-gate registration is not finite")
    emit(phase="icp_wide_gate_path", max_corr_dist_sq=0.25, launches=launches,
         iterations=int(res.iterations), ms=ms, translation_error_m=dt, rotation_error_rad=dr)
    return launches


def rigid_fit(a: np.ndarray, b: np.ndarray):
    """``(R, t)`` with ``b ≈ a @ R.T + t`` for paired rows (Kabsch, float64)."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    ca, cb = a.mean(0), b.mean(0)
    u, _, vt = np.linalg.svd((b - cb).T @ (a - ca))
    r = u @ np.diag([1.0, 1.0, np.sign(np.linalg.det(u @ vt))]) @ vt
    return r, cb - r @ ca


def entry_path(nn):
    """Phase 8: the port's ``entry()`` forward on the card (the fused
    kernel). The toy pair was made by one rigid transform of paired points,
    recovered here exactly by a fit; the registration stops unconverged
    after its 10 iterations, so it is held to 5e-3, a tenth of the
    motion. Card against CPU is
    ``tests/test_torch_nn1_cuda.py``'s to check."""
    from cilantro_tpu_torch.entry import entry

    fwd, args = entry()
    nn.reset_launch_counts()
    t0 = time.perf_counter()
    lin, tr = fwd(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(nn.launch_counts)
    if launches["nn1_fused"] == 0:
        raise AssertionError(f"entry() did not run the fused kernel: {launches}")
    r, t = rigid_fit(args[0].cpu().numpy(), args[1].cpu().numpy())
    rel = np.eye(4)
    rel[:3, :3], rel[:3, 3] = r, t
    dt, dr = gt_error(lin, tr, rel)
    true_t, true_r = gt_error(torch.eye(3), torch.zeros(3), rel)
    if not (dt < 5e-3 and dr < 5e-3):
        raise AssertionError(
            f"entry() is off by {dt} m / {dr} rad; the pair is {true_t} m / {true_r} rad apart"
        )
    emit(phase="entry", launches=launches, ms=ms, translation_error_m=dt,
         rotation_error_rad=dr, true_translation_m=true_t, true_rotation_rad=true_r)
    return launches


def icp_card_vs_cpu(nn, icp_mod, k_small):
    """Phase 9: ``icp_multires`` on a 160×120 pair on the card and on the
    CPU; the CPU run is pruned as the card's is (the plain versions of the
    compact and masked kernels), by lifting ``prune_eligible``'s device
    test for that call."""
    from unittest import mock

    from cilantro_tpu_torch.slam.driver import synthetic_sequence

    depths, _ = synthetic_sequence(2, 120, 160, k_small, seed=0)
    eligible = nn.prune_eligible
    results = {}
    for dev in (torch.device("cuda"), torch.device("cpu")):
        (p0, n0, v0), (p1, _, v1) = (frame_clouds(d, k_small, dev) for d in depths)
        with mock.patch.object(
            nn, "prune_eligible",
            lambda q, k, m, metric="l2", device=None: eligible(q, k, m, metric, device="cuda"),
        ):
            nn.reset_launch_counts()
            res = icp_mod.icp_multires(
                p1, p0, dst_normals=n0, src_valid=v1, dst_valid=v0, metric="combined",
                convergence_tol=1e-4, levels=BENCH_LEVELS,
            )
        results[dev.type] = (res.transform, dict(nn.launch_counts))
    (tf_g, l_g), (tf_c, l_c) = results["cuda"], results["cpu"]
    if sum(l_c.values()) or l_g["nn1_compact"] == 0:
        raise AssertionError(f"launches: card {l_g}, CPU {l_c}")
    dt = float((tf_g.translation.cpu() - tf_c.translation).abs().max())
    dr = rot_angle(tf_g.linear.cpu().numpy(), tf_c.linear.numpy())
    emit(phase="icp_card_vs_cpu", height=120, width=160, card_launches=l_g,
         max_translation_diff_m=dt, max_rotation_diff_rad=dr)
    if not (dt < 1e-4 and dr < 1e-4):
        raise AssertionError(f"card and CPU registrations differ by {dt} m / {dr} rad")


REPLACES = {
    "nn1_fused": "cilantro_tpu/neighbors/pallas_nn.py:151",
    "nn1_masked": "cilantro_tpu/neighbors/pallas_nn.py:247",
    "nn1_compact": "cilantro_tpu/neighbors/pallas_nn.py:363",
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

    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
        entry["path"] = "splat fusion, 16 frames"

    # 5. nn1 kernels vs plain on the card.
    from cilantro_tpu_torch.entry import _toy_pair
    from cilantro_tpu_torch.neighbors import fused_nn
    from cilantro_tpu_torch.registration import icp as icp_mod

    pair = (frame_clouds(depths[1], k, dev), frame_clouds(depths[0], k, dev))
    rel = np.linalg.inv(gt[0]) @ gt[1]  # frame 1's camera in frame 0's
    coarse = coarse_clouds(*pair, BENCH_LEVELS[0])
    toy = [torch.as_tensor(a, device=dev) for a in _toy_pair()]
    nn1 = nn1_kernel_checks(fused_nn, pair, coarse, toy)

    # 6-8. The ICP paths: main path, wide gate, entry().
    nn1["nn1_compact"]["launches"] = icp_main_path(fused_nn, icp_mod, pair, rel, card)["nn1_compact"]
    nn1["nn1_compact"]["path"] = "icp_multires, 640x480 pair, bench levels"
    nn1["nn1_masked"]["launches"] = wide_gate_path(fused_nn, icp_mod, pair, rel)["nn1_masked"]
    nn1["nn1_masked"]["path"] = "icp, 640x480 pair, entry() settings (0.5 m gate)"
    nn1["nn1_fused"]["launches"] = entry_path(fused_nn)["nn1_fused"]
    nn1["nn1_fused"]["path"] = "entry(), 4096-point pair"

    # 9. ICP card vs CPU.
    icp_card_vs_cpu(fused_nn, icp_mod, CameraIntrinsics.make(131.25, 131.25, 79.5, 59.5))

    # The kernels line, the card, the result.
    kernels += [nn1[name] for name in ("nn1_fused", "nn1_masked", "nn1_compact")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
