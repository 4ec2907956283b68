"""Fusion-sequence driver, trajectory metric and synthetic input (port of
``cilantro_tpu/slam/driver.py``).

:func:`run_fusion_sequence` is the host loop of the pool pipeline,
:func:`run_fusion_sequence_scanned` its CUDA-graph replay.
:func:`synthetic_sequence` and :func:`synthetic_panorama_sequence` are
verbatim copies of the JAX package's numpy renderers: for the same
arguments they return bit-identical depths and poses.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.rgbd import CameraIntrinsics, depth_to_points_normals
from ..core.transforms import Transform, from_matrix, identity
from ..registration.transform_estimation import estimate_rigid_point_to_point
from .fusion import (
    FusionConfig,
    FusionMap,
    fusion_step,
    init_map_from_frame,
    seed_localize_target,
)
from ..utils.profiling import annotate_function, count, span
from .scan import RUNS, scan


@dataclasses.dataclass
class FusionMetrics:
    poses: List[np.ndarray]  # (4, 4) camera-to-world per frame
    frames: int
    seconds_per_frame: float
    icp_iterations: List[int]
    num_map_points: int


def run_fusion_sequence(
    depths: Sequence[np.ndarray],  # (H, W) metric depth per frame
    intrinsics: CameraIntrinsics,
    *,
    colors: Optional[Sequence[np.ndarray]] = None,
    map_capacity: Optional[int] = None,
    cfg: FusionConfig = FusionConfig(),
    integrate_every: int = 1,
    resume_from: Optional[str] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    on_frame=None,
    device="cuda",
) -> Tuple[FusionMap, FusionMetrics]:
    """Frame-to-model fusion over a depth sequence on ``device`` (world
    frame = first camera). Returns the final map and per-frame metrics;
    ``seconds_per_frame`` is the steady state by the host clock, the first
    tracked frame excluded.

    ``resume_from`` restarts from a checkpoint an earlier run over the same
    sequence wrote (this package's or the JAX package's); the continuation
    equals the uninterrupted run's. ``checkpoint_path`` writes checkpoints
    (:mod:`.checkpoint`) every ``checkpoint_every`` frames, or once at the
    end when that is None.

    ``on_frame``: optional ``callback(frame_idx, fmap, pose)`` after each
    frame; an exception in it is reported and the run goes on. Its time and
    the checkpoint writes' are not counted."""
    from .checkpoint import load_checkpoint, save_checkpoint

    dev = resolve_device(device)
    h, w = depths[0].shape
    if map_capacity is None:
        map_capacity = 4 * h * w
    staged = [torch.as_tensor(np.asarray(d, np.float32), device=dev) for d in depths]
    col_staged = (
        [torch.as_tensor(np.asarray(c, np.float32).reshape(-1, 3), device=dev) for c in colors]
        if colors is not None else None
    )
    if resume_from is not None:
        ck = load_checkpoint(resume_from)
        fmap = ck.fusion_map(dev)
        poses_dev = [torch.as_tensor(p, device=dev) for p in ck.poses]
        pose = from_matrix(poses_dev[-1])
        iterations = ([int(i) for i in ck.icp_iterations] if ck.icp_iterations is not None
                      else [0] * len(ck.poses))
        imap = None if ck.index_map is None else torch.as_tensor(ck.index_map, device=dev)
        start = ck.next_frame
    else:
        pts, nrm, valid = depth_to_points_normals(staged[0], intrinsics)
        fmap = init_map_from_frame(
            map_capacity, pts, nrm, col_staged[0] if col_staged else None, valid
        )
        pose = identity(3, device=dev)
        poses_dev = [pose.matrix()]
        iterations = [0]
        imap = None
        start = 1
    packed = None  # rebuilt from imap on the first step, then each integrate's

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def save(next_frame):
        save_checkpoint(checkpoint_path, fmap, [p.cpu().numpy() for p in poses_dev], next_frame,
                        index_map=imap, icp_iterations=iterations)

    t0 = time.perf_counter()
    t_first = None
    t_hook = 0.0
    for fi in range(start, len(depths)):
        pts, nrm, valid = depth_to_points_normals(staged[fi], intrinsics)
        fmap, pose, res, imap, packed = fusion_step(
            fmap, pts, nrm, col_staged[fi] if col_staged else None, valid, pose, intrinsics,
            cached_index_map=imap, cached_packed_target=packed,
            height=h, width=w, cfg=cfg, do_integrate=fi % integrate_every == 0,
        )
        poses_dev.append(pose.matrix())
        iterations.append(int(res.iterations))
        if t_first is None:
            sync()
            t_first = time.perf_counter()
        if on_frame is not None:
            sync()
            tc = time.perf_counter()
            try:
                on_frame(fi, fmap, pose)
            except Exception as e:  # a viewer must never stop the pipeline
                print(f"on_frame failed at frame {fi}: {type(e).__name__}: {e}", file=sys.stderr)
            t_hook += time.perf_counter() - tc
        if checkpoint_path is not None and checkpoint_every is not None and (
            (fi - start + 1) % checkpoint_every == 0
        ):
            sync()
            tc = time.perf_counter()
            save(fi + 1)
            t_hook += time.perf_counter() - tc
    n_map = int(fmap.num_points())
    t_end = time.perf_counter()
    n_steps = len(depths) - start
    if n_steps >= 2:
        dt = (t_end - t_first - t_hook) / (n_steps - 1)
    else:
        dt = (t_end - t0 - t_hook) / max(n_steps, 1)
    if checkpoint_path is not None and checkpoint_every is None:
        save(len(depths))
    return fmap, FusionMetrics(
        poses=[p.cpu().numpy() for p in poses_dev],
        frames=len(depths),
        seconds_per_frame=dt,
        icp_iterations=iterations,
        num_map_points=n_map,
    )


def run_fusion_sequence_scanned(
    depths: Sequence[np.ndarray],
    intrinsics: CameraIntrinsics,
    *,
    map_capacity: Optional[int] = None,
    cfg: FusionConfig = FusionConfig(),
    device="cuda",
    stats: Optional[dict] = None,
) -> Tuple[FusionMap, FusionMetrics]:
    """Whole-sequence fusion, the counterpart of the JAX package's one
    jitted ``lax.scan``: one :func:`.fusion.fusion_step` with the graph form
    of ICP (all ``cfg.icp_iterations``, the early exit by a device flag)
    captured in a CUDA graph and replayed once a frame
    (:func:`.scan.scan`); eager steps on the CPU. The first localize target
    is a render of the seeded map, then each integrate's. Returns what
    :func:`run_fusion_sequence` returns; ``seconds_per_frame`` is that of
    the fastest of 3 runs of the sequence by the host clock (capture and a
    first run excluded, as the JAX driver excludes its compile; each run
    ended by the read-back of the poses). ``stats``, if given, receives
    ``device_seconds_per_frame`` (CUDA events, ``None`` on the CPU) and
    ``launches_per_frame`` (every kernel counter).

    On the card a later call with the same ``cfg``, ``intrinsics``, frame
    shape, ``map_capacity`` and device, this entry's or ``run_slam``'s
    scanned front end's, replays the step the first captured, with no
    warm-up and no capture (:func:`.scan.scan`'s ``key``);
    ``seconds_per_frame`` keeps its meaning. Between calls the entry keeps
    that one graph, its pool and its static buffers (the pool, a pose, the
    packed target, a frame, a step's outputs); a call with another key
    replaces them, :func:`.scan.clear` frees them."""
    return _fusion_scanned(depths, intrinsics, map_capacity, cfg, resolve_device(device), stats,
                           RUNS)


@annotate_function("cilantro.entry.fusion_scanned")
def _fusion_scanned(depths, intrinsics, map_capacity, cfg, dev, stats, runs):
    """:func:`run_fusion_sequence_scanned` with the passes over the
    sequence chosen (:func:`.scan.scan`'s ``runs``): ``run_slam`` takes its
    odometry from one pass (after the capture, where no earlier call
    left the step kept). The call is a
    ``cilantro.entry.fusion_scanned`` span, with ``entry.prepare`` and
    ``entry.finish`` spans and the ``gn_iterations_kept`` /
    ``gn_iterations_run`` counters inside (:mod:`..utils.profiling`)."""
    h, w = depths[0].shape
    if map_capacity is None:
        map_capacity = 4 * h * w
    with span("cilantro.entry.prepare"):
        pts, nrm, valid = depth_to_points_normals(
            torch.as_tensor(np.asarray(depths[0], np.float32), device=dev), intrinsics
        )
        fmap0 = init_map_from_frame(map_capacity, pts, nrm, None, valid)
        if len(depths) == 1:  # nothing to track: the seeded map is the result
            if stats is not None:
                stats.update(device_seconds_per_frame=None, launches_per_frame={})
            return fmap0, FusionMetrics(
                poses=[np.eye(4, dtype=np.float32)],
                frames=1,
                seconds_per_frame=0.0,
                icp_iterations=[0],
                num_map_points=int(fmap0.num_points()),
            )
        depth_stack = torch.as_tensor(np.stack([np.asarray(d, np.float32) for d in depths[1:]]),
                                      device=dev)
        pose0 = identity(3, device=dev)
        _, packed0 = seed_localize_target(fmap0, pose0, intrinsics, h, w)

    def step(carry, depth):
        data, linear, translation, packed = carry
        p, n, v = depth_to_points_normals(depth, intrinsics)
        fmap, pose, res, _, packed = fusion_step(
            FusionMap(data=data), p, n, None, v, Transform(linear, translation), intrinsics,
            cached_packed_target=packed, height=h, width=w, cfg=cfg, loop="graph",
        )
        return (fmap.data, pose.linear, pose.translation, packed), (pose.matrix(), res.iterations)

    out = scan(
        step, (fmap0.data, pose0.linear, pose0.translation, packed0), depth_stack, runs=runs,
        key=("fusion_scanned", cfg, intrinsics, h, w),
    )
    with span("cilantro.entry.finish"):
        fmap = FusionMap(data=out.carry[0])
        mats, iterations = out.ys
        count("gn_iterations_kept", iterations.sum())
        count("gn_iterations_run", cfg.icp_iterations * len(iterations))
        if stats is not None:
            stats.update(device_seconds_per_frame=out.device_seconds_per_step,
                         launches_per_frame=dict(out.launches_per_step))
        return fmap, FusionMetrics(
            poses=[np.eye(4, dtype=np.float32)] + list(mats),
            frames=len(depths),
            seconds_per_frame=out.seconds_per_step,
            icp_iterations=[0] + [int(i) for i in iterations],
            num_map_points=int(fmap.num_points()),
        )


def ate_rmse(
    est_poses: Sequence[np.ndarray],
    gt_poses: Sequence[np.ndarray],
    *,
    device="cuda",
) -> float:
    """Absolute trajectory error (RMSE of positions) after rigid Umeyama
    alignment of the estimated trajectory onto the ground truth; the
    alignment is fitted on ``device``."""
    dev = resolve_device(device)
    est = np.stack([p[:3, 3] for p in est_poses])
    gt = np.stack([p[:3, 3] for p in gt_poses])
    if len(est) >= 3 and np.linalg.matrix_rank(est - est.mean(0)) >= 2:
        tf, ok = estimate_rigid_point_to_point(
            torch.as_tensor(est, dtype=torch.float32, device=dev),
            torch.as_tensor(gt, dtype=torch.float32, device=dev),
        )
        if bool(ok):
            est = est @ tf.linear.cpu().numpy().T + tf.translation.cpu().numpy()
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))


def synthetic_sequence(
    num_frames: int,
    h: int,
    w: int,
    intrinsics: CameraIntrinsics,
    *,
    seed: int = 0,
    motion_scale: float = 0.004,
    cache_dir: Optional[str] = None,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Render a wavy-room depth sequence from a smoothly moving camera.

    Returns (depth frames, ground-truth camera-to-world 4×4 poses). The
    scene is a dense height-field point set rendered through a numpy
    z-buffer — data generation stays entirely on the host (no device
    contact) so benchmarks measure the pipeline, not the renderer.

    ``cache_dir``: if given, the rendered stack is memoized to
    ``{cache_dir}/seq_{frames}x{h}x{w}_s{seed}_m{motion}.npz`` and later
    calls with the same key load instead of re-rendering (bench runs under a
    wall budget must not spend it re-rendering identical input).
    """
    cache_path = None
    if cache_dir is not None:
        import os as _os

        _os.makedirs(cache_dir, exist_ok=True)
        _k = "-".join(
            f"{float(np.asarray(v)):g}"
            for v in (intrinsics.fx, intrinsics.fy,
                      intrinsics.cx, intrinsics.cy)
        )
        cache_path = _os.path.join(
            cache_dir,
            f"seq_{num_frames}x{h}x{w}_s{seed}_m{motion_scale:g}_k{_k}.npz",
        )
        if _os.path.exists(cache_path):
            try:
                with np.load(cache_path) as z:
                    return (
                        [d for d in z["depths"]],
                        [p for p in z["poses"]],
                    )
            except Exception:
                pass  # corrupt cache: fall through and re-render
    rng = np.random.default_rng(seed)
    fx = float(np.asarray(intrinsics.fx))
    fy = float(np.asarray(intrinsics.fy))
    cx = float(np.asarray(intrinsics.cx))
    cy = float(np.asarray(intrinsics.cy))

    def render_depth(cam_pts: np.ndarray) -> np.ndarray:
        z = cam_pts[:, 2]
        ok = z > 0
        u = np.round(cam_pts[:, 0] * fx / np.where(ok, z, 1.0) + cx).astype(np.int64)
        v = np.round(cam_pts[:, 1] * fy / np.where(ok, z, 1.0) + cy).astype(np.int64)
        ok &= (u >= 0) & (u < w) & (v >= 0) & (v < h)
        pix = v[ok] * w + u[ok]
        zbuf = np.full(h * w, np.inf, np.float32)
        np.minimum.at(zbuf, pix, z[ok].astype(np.float32))
        return np.where(np.isinf(zbuf), 0.0, zbuf).reshape(h, w)
    # Dense scene: height field over x-y at ~2 m depth, 4 samples per pixel.
    gx, gy = np.meshgrid(
        np.linspace(-1.6, 1.6, 2 * w), np.linspace(-1.2, 1.2, 2 * h)
    )
    gz = (
        2.0
        + 0.25 * np.sin(2.0 * gx) * np.cos(1.5 * gy)
        + 0.05 * np.sin(7.0 * gx)
    )
    scene = np.column_stack(
        [gx.ravel(), gy.ravel(), gz.ravel()]
    ).astype(np.float32)

    depths, poses = [], []
    ang = 0.0
    pos = np.zeros(3)
    vel = rng.standard_normal(3) * motion_scale
    for i in range(num_frames):
        r = np.array(
            [
                [np.cos(ang), 0, np.sin(ang)],
                [0, 1, 0],
                [-np.sin(ang), 0, np.cos(ang)],
            ],
            np.float32,
        )
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = r
        pose[:3, 3] = pos
        poses.append(pose)
        # Render: scene in camera frame = R⁻¹(X − t).
        cam_pts = (scene - pose[:3, 3]) @ r  # (N, 3) @ R = Rᵀ applied rowwise
        dn = render_depth(cam_pts.astype(np.float32))
        # Fill tiny z-buffer holes from the 3×3 neighborhood. grey_dilation
        # is a MAX filter (holes carry 0, so any real neighbor wins); the
        # filled depth is therefore the FARTHEST neighbor, a conservative
        # choice that cannot hallucinate surface in front of the scene.
        holes = dn == 0
        if holes.any():
            from scipy.ndimage import grey_dilation

            filled = grey_dilation(np.where(holes, 0.0, dn), size=3)
            dn = np.where(holes, filled, dn)
        depths.append(dn.astype(np.float32))
        # Smooth random walk.
        ang += rng.standard_normal() * motion_scale
        vel = 0.9 * vel + rng.standard_normal(3) * motion_scale * 0.5
        pos = pos + vel
    if cache_path is not None:
        import os as _os

        tmp = cache_path + ".tmp"
        with open(tmp, "wb") as f:  # savez on a file object keeps the name
            np.savez(f, depths=np.stack(depths), poses=np.stack(poses))
        _os.replace(tmp, cache_path)
    return depths, poses


def synthetic_panorama_sequence(
    num_frames: int,
    h: int,
    w: int,
    intrinsics: CameraIntrinsics,
    *,
    seed: int = 0,
    sweep_deg: float = 360.0,
    room_radius: float = 2.5,
    depth_noise: float = 0.02,
    cache_dir: Optional[str] = None,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """In-place panorama sweep with DRIFT-INDUCING depth noise — the SLAM
    loop-closure workload (:func:`.slam.run_slam`).

    The camera sits at the origin and yaws through ``sweep_deg`` in equal
    steps, viewing a wavy cylindrical room. Each frame's depth is warped by
    a smooth low-frequency random field of relative amplitude
    ``depth_noise``: unlike white noise (which averages out over 10⁵ pixels
    and leaves frame-to-model tracking drift-free), correlated error biases
    each localization by a random ~0.1-0.5° — so odometry accumulates a
    random-walk yaw drift that only a loop closure can remove. Returns
    ``(depths, ground-truth camera-to-world poses)``.
    """
    cache_path = None
    if cache_dir is not None:
        import os as _os

        _os.makedirs(cache_dir, exist_ok=True)
        cache_path = _os.path.join(
            cache_dir,
            f"pano_{num_frames}x{h}x{w}_s{seed}_d{sweep_deg:g}"
            f"_n{depth_noise:g}_r{room_radius:g}.npz",
        )
        if _os.path.exists(cache_path):
            try:
                with np.load(cache_path) as z:
                    return [d for d in z["depths"]], [p for p in z["poses"]]
            except Exception:
                pass
    rng = np.random.default_rng(seed)
    fx = float(np.asarray(intrinsics.fx))
    fy = float(np.asarray(intrinsics.fy))
    cx = float(np.asarray(intrinsics.cx))
    cy = float(np.asarray(intrinsics.cy))

    # Wavy cylindrical room around the origin (dense angular sampling so
    # every view direction sees surface).
    n_th = max(4096, 10 * w)
    n_y = 4 * h
    th = np.linspace(0.0, 2 * np.pi, n_th, endpoint=False)
    yy = np.linspace(-1.4, 1.4, n_y)
    tg, yg = np.meshgrid(th, yy)
    # Feature-rich wall: a random-phase sum of cross-coupled θ/y modes.
    # A smooth cylinder is yaw↔lateral-slide degenerate under
    # partial-overlap ICP (measured: ~0.3 m tangential slide at converged
    # residual), and a REGULAR bump pattern aliases into false minima
    # (measured: a consistent ~11° lock-in offset); integer θ frequencies
    # keep the 2π seam continuous while random phases/mixtures leave one
    # global basin. The texture is a fixed property of the scene (seeded
    # separately from the per-frame noise).
    rng_scene = np.random.default_rng(10_000 + seed)
    r = room_radius + 0.18 * np.sin(3.0 * tg) * np.cos(2.0 * yg)
    for _ in range(16):
        f_th = int(rng_scene.integers(2, 26))
        f_y = float(rng_scene.uniform(0.0, 6.0))
        amp = float(rng_scene.uniform(0.5, 1.0)) * 0.55 / (2.0 + f_th)
        r = r + amp * np.sin(
            f_th * tg + rng_scene.uniform(0, 2 * np.pi)
        ) * np.cos(f_y * yg + rng_scene.uniform(0, 2 * np.pi))
    scene = np.column_stack(
        [(r * np.sin(tg)).ravel(), yg.ravel(), (r * np.cos(tg)).ravel()]
    ).astype(np.float32)

    def render_depth(cam_pts: np.ndarray) -> np.ndarray:
        z = cam_pts[:, 2]
        ok = z > 0.1
        u = np.round(cam_pts[:, 0] * fx / np.where(ok, z, 1.0) + cx).astype(np.int64)
        v = np.round(cam_pts[:, 1] * fy / np.where(ok, z, 1.0) + cy).astype(np.int64)
        ok &= (u >= 0) & (u < w) & (v >= 0) & (v < h)
        pix = v[ok] * w + u[ok]
        zbuf = np.full(h * w, np.inf, np.float32)
        np.minimum.at(zbuf, pix, z[ok].astype(np.float32))
        return np.where(np.isinf(zbuf), 0.0, zbuf).reshape(h, w)

    def smooth_noise() -> np.ndarray:
        coarse = rng.standard_normal((6, 8)).astype(np.float32)
        from scipy.ndimage import zoom

        f = zoom(coarse, (h / 6.0, w / 8.0), order=1)[:h, :w]
        return 1.0 + depth_noise * f

    depths, poses = [], []
    for i in range(num_frames):
        ang = np.deg2rad(sweep_deg) * i / num_frames
        rmat = np.array(
            [
                [np.cos(ang), 0, np.sin(ang)],
                [0, 1, 0],
                [-np.sin(ang), 0, np.cos(ang)],
            ],
            np.float32,
        )
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = rmat
        poses.append(pose)
        cam_pts = scene @ rmat  # camera at origin: Rᵀ · X rowwise
        dn = render_depth(cam_pts.astype(np.float32))
        holes = dn == 0
        if holes.any():
            from scipy.ndimage import grey_dilation

            filled = grey_dilation(np.where(holes, 0.0, dn), size=3)
            dn = np.where(holes, filled, dn)
        depths.append((dn * smooth_noise()).astype(np.float32))
    if cache_path is not None:
        import os as _os

        tmp = cache_path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, depths=np.stack(depths), poses=np.stack(poses))
        _os.replace(tmp, cache_path)
    return depths, poses
