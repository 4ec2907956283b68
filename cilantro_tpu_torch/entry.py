"""Driver entry points (port of the JAX package's ``__graft_entry__.py``).

``entry()``              the forward step on the toy pair: one rigid
                         combined-metric ICP registration of a 4096-point
                         wavy sheet onto a rotated and shifted copy. At
                         4096 × 4096 pairs (below the 2²⁶ prune threshold)
                         each correspondence pass runs the fused nn1 kernel
                         on CUDA.
``dryrun_multichip(n)``  every sharded path once over an ``n``-rank mesh
                         (one process a rank, e.g. under ``torchrun``), at
                         the shapes the JAX function uses.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .registration.icp import icp


def _toy_pair(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    z = (0.3 * np.sin(2 * xy[:, 0]) * np.cos(2 * xy[:, 1])).astype(np.float32)
    pts = np.column_stack([xy, z])
    ang = 0.05
    r = np.array(
        [
            [np.cos(ang), -np.sin(ang), 0],
            [np.sin(ang), np.cos(ang), 0],
            [0, 0, 1],
        ],
        np.float32,
    )
    t = np.array([0.02, -0.01, 0.015], np.float32)
    dst = pts @ r.T + t
    nrm = np.zeros_like(dst)
    nrm[:, 2] = 1.0
    return pts, dst, nrm


def entry(device="cuda"):
    """``(forward, (src, dst, dst_normals))``: ``forward`` runs one full
    rigid combined-metric ICP registration and returns the transform's
    ``(linear, translation)``; the inputs lie on ``device``."""
    dev = resolve_device(device)
    pts, dst, nrm = _toy_pair()

    def forward(src_points, dst_points, dst_normals):
        res = icp(
            src_points,
            dst_points,
            dst_normals=dst_normals,
            metric="combined",
            point_weight=0.3,
            max_corr_dist_sq=0.25,
            max_iterations=10,
        )
        return res.transform.linear, res.transform.translation

    inputs = tuple(torch.as_tensor(a, device=dev) for a in (pts, dst, nrm))
    return forward, inputs


# ---------------------------------------------------------------------------
# dryrun_multichip: each part a helper that takes its mesh and sizes.
# ---------------------------------------------------------------------------


def _icp_mesh_shape(n_devices: int):
    """The tournament ICP's ``(points, map)`` shape: two map shards when
    the rank count is even, else one."""
    n_map = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    return n_devices // n_map, n_map


def _dryrun_tournament_icp(mesh, n=1024):
    """Sharded combined ICP on the ``n``-point toy pair, the source over
    ``points`` and the map over ``map``: ``(Transform, iterations)``."""
    from .parallel import shard_cloud_arrays, sharded_combined_icp

    pts, dst, nrm = _toy_pair(n=n)
    ones = np.ones(n, bool)
    src_s, sv = shard_cloud_arrays(mesh, "points", pts, ones)
    dst_s, dn, dv = shard_cloud_arrays(mesh, "map", dst, nrm, ones)
    return sharded_combined_icp(src_s, sv, dst_s, dn, dv, mesh=mesh, max_corr_dist_sq=0.25, max_iterations=2,
                                point_weight=0.3)


def _ba_problem(n_devices: int, rng):
    """The BA part's arrays, drawn from ``rng``: 4 cameras at the identity,
    ``16·n_devices`` landmarks each seen once as itself, and each
    observation's landmark id local to its equal contiguous shard."""
    n_cams, n_lmk = 4, 16 * n_devices
    lmk = (rng.standard_normal((n_lmk, 3)) + [0, 0, 5.0]).astype(np.float32)
    cam = np.tile(np.arange(n_cams, dtype=np.int32), n_lmk // n_cams * 4)[:n_lmk]
    per = n_lmk // n_devices
    local = (np.arange(n_lmk, dtype=np.int32) % per).astype(np.int32)
    return lmk, cam, local, lmk, np.ones(n_lmk, bool)


def _dryrun_ba(mesh, n_devices: int, rng):
    """Landmark-sharded Schur BA, 2 iterations: ``(poses, this rank's
    landmarks, residual)``."""
    from .core.transforms import Transform
    from .parallel import shard_cloud_arrays
    from .parallel.sharded import mesh_device
    from .slam import bundle_adjust_sharded

    dev = mesh_device(mesh)
    lmk, cam, local, obs, valid = _ba_problem(n_devices, rng)
    poses0 = Transform(torch.eye(3, device=dev).expand(4, 3, 3).contiguous(), torch.zeros((4, 3), device=dev))
    shards = shard_cloud_arrays(mesh, "points", lmk, cam, local, obs, valid)
    return bundle_adjust_sharded(poses0, *shards, mesh=mesh, max_iterations=2)


def _dryrun_ring_icp(mesh, n=1024):
    """Ring-rotation ICP, both clouds over ``points``: ``(Transform,
    iterations)``."""
    from .parallel import shard_cloud_arrays, sharded_combined_icp_ring

    pts, dst, nrm = _toy_pair(n=n)
    ones = np.ones(n, bool)
    args = shard_cloud_arrays(mesh, "points", pts, ones, dst, nrm, ones)
    return sharded_combined_icp_ring(*args, mesh=mesh, max_corr_dist_sq=0.25, max_iterations=2,
                                     point_weight=0.3)


def _fusion_intrinsics(height: int, width: int, focal: float):
    from .core.rgbd import CameraIntrinsics

    return CameraIntrinsics.make(focal, focal, width / 2 - 0.5, height / 2 - 0.5)


def _dryrun_fusion(mesh, depths, intrinsics, capacity: int):
    """Map-sharded fusion: the pool of ``capacity`` slots seeded from
    frame 0, then one ``sharded_fusion_step`` a later frame (stride-2
    localize). Returns this rank's pool shard, the poses (4×4 numpy, one a
    step) and the last winner image."""
    from .core.rgbd import depth_to_points_normals
    from .core.transforms import identity
    from .parallel import init_sharded_map, sharded_fusion_step
    from .parallel import collectives as cc
    from .parallel.sharded import mesh_device
    from .slam import FusionConfig

    dev = mesh_device(mesh)
    h, w = depths[0].shape
    frames = [depth_to_points_normals(torch.as_tensor(np.asarray(d, np.float32), device=dev), intrinsics)
              for d in depths]
    p0, n0, v0 = frames[0]
    sdata = init_sharded_map(mesh, capacity, p0, n0, None, v0)
    pose, poses, widx = identity(3, device=dev), [], None
    for p, nr, v in frames[1:]:
        sdata, pose, widx = sharded_fusion_step(sdata, p, nr, None, v, pose, intrinsics, mesh=mesh, height=h,
                                                width=w, cfg=FusionConfig(localize_stride=2))
        poses.append(pose.matrix().cpu().numpy())
    shards = cc.axis_size(mesh, "map")
    if tuple(sdata.shape) != (capacity // shards, 16):
        raise AssertionError(f"pool shard {tuple(sdata.shape)}, want ({capacity // shards}, 16)")
    return sdata, poses, widx


def _dryrun_pipeline(depths, intrinsics, capacity: int, device, timeout=None):
    """The two-stage pipeline on ranks 0 and 1 of the process group (the
    front end on rank 0, the tracker on rank 1), or on two CUDA streams of
    ``device`` in a world of one. Every rank calls it, as the group is
    made on each; ranks past 1 then return None, as the JAX function leaves
    devices past the first two idle. Otherwise ``(map, metrics)``."""
    import torch.distributed as dist

    from .slam import FusionConfig, make_pipeline_mesh, run_fusion_sequence_pipelined

    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = make_pipeline_mesh(timeout=timeout) if world >= 2 else make_pipeline_mesh([device, device])
    if mesh is None:
        return None
    fmap, met = run_fusion_sequence_pipelined(list(depths), intrinsics, mesh=mesh, map_capacity=capacity,
                                              cfg=FusionConfig(localize_stride=2), device=device)
    if len(met.poses) != len(depths):
        raise AssertionError(f"{len(met.poses)} pipeline poses for {len(depths)} frames")
    return fmap, met


def _warp_problem(n_devices: int, rng):
    """The warp part's arrays, drawn from ``rng`` after the BA's: ``128·n``
    points in a 2 m cube, their target 1 cm up, every (n·8)-th point a
    node."""
    wn = 128 * n_devices
    wsrc = rng.uniform(-1, 1, (wn, 3)).astype(np.float32)
    wdst = wsrc + np.float32([0, 0, 0.01])
    return wsrc, wdst, wsrc[:: max(wn // 16, 1)]


def _dryrun_warp(mesh, n_devices: int, rng):
    """Point-sharded warp-field GN (2 GN iterations of at most 20 CG
    iterations each): ``(node transforms, converged, CG iterations)``."""
    from .parallel import sharded_estimate_warp_field
    from .parallel.sharded import mesh_device
    from .registration.warp_field import build_deformation_graph

    dev = mesh_device(mesh)
    wsrc, wdst, wnodes = _warp_problem(n_devices, rng)
    graph = build_deformation_graph(wsrc, wnodes, k_anchors=4, k_arcs=4, device=dev)
    return sharded_estimate_warp_field(graph, wsrc, wdst, None, np.ones(len(wsrc), np.float32), mesh=mesh,
                                       point_weight=1.0, plane_weight=0.0, max_gn_iterations=2,
                                       max_cg_iterations=20)


# The entry's fusion runs: ((height, width, focal), frames, pool slots a
# pixel), one step at 640x480 and two at 320x240.
_FUSION_RUNS = (((480, 640, 525.0), 2, 4), ((240, 320, 262.5), 3, 2))


def _dryrun_parts(n_devices: int, device, *, fusion_runs=None, timeout=None, run=None) -> dict:
    """Every part of :func:`dryrun_multichip` on this rank, in its order
    and with its meshes and draws: ``{part: its helper's output}`` (the
    pipeline's None past rank 1). ``fusion_runs`` is ``[(label, depths,
    intrinsics, capacity), ...]`` (default: the entry's 640×480 and
    320×240 runs, labelled ``fusion_<W>x<H>``); the pipeline runs on the
    last run's frames with 2 slots a pixel. ``timeout`` bounds every group
    made here; ``run(part, fn)`` calls each part's ``fn`` (default
    ``fn()``), so that a caller can time it. Every rank makes the same
    groups in the same order."""
    from .parallel import make_mesh
    from .slam import synthetic_sequence

    dev = resolve_device(device)
    run = run or (lambda part, fn: fn())
    kw = {} if timeout is None else {"timeout": timeout}

    def mesh(p, q):
        return make_mesh(p, q, device=dev, **kw)

    if fusion_runs is None:
        fusion_runs = []
        for (fh, fw, focal), frames, pool in _FUSION_RUNS:
            cam_k = _fusion_intrinsics(fh, fw, focal)
            depths, _ = synthetic_sequence(frames, fh, fw, cam_k, seed=1)
            fusion_runs.append((f"fusion_{fw}x{fh}", depths, cam_k, ((pool * fh * fw) // n_devices) * n_devices))
    out = {}
    m = mesh(*_icp_mesh_shape(n_devices))
    out["tournament_icp"] = run("tournament_icp", lambda: _dryrun_tournament_icp(m))
    rng = np.random.default_rng(0)
    m = mesh(n_devices, 1)
    out["ba"] = run("ba", lambda: _dryrun_ba(m, n_devices, rng))
    m = mesh(n_devices, 1)
    out["ring_icp"] = run("ring_icp", lambda: _dryrun_ring_icp(m))
    m = mesh(1, n_devices)
    for label, depths, cam_k, cap in fusion_runs:
        out[label] = run(label, lambda: _dryrun_fusion(m, depths, cam_k, cap))
    out["pipeline"] = run("pipeline", lambda: _dryrun_pipeline(depths, cam_k, 2 * depths[0].size, dev, timeout))
    m = mesh(n_devices, 1)
    out["warp"] = run("warp", lambda: _dryrun_warp(m, n_devices, rng))
    return out


def dryrun_multichip(n_devices: int, *, device="cuda") -> None:
    """Every sharded path once over an ``n_devices``-rank mesh, in the JAX
    function's order and at its shapes: tournament ICP on a ``(n/2, 2)``
    (or ``(n, 1)``) mesh, the landmark-sharded BA, ring ICP, map-sharded
    fusion at 640×480 (a 4·H·W-slot pool, one step) and at 320×240 (two
    steps), the two-stage pipeline and the point-sharded warp GN.

    Every rank calls it after ``parallel.initialize_distributed()`` (e.g.
    under ``torchrun --nproc-per-node=N``) with ``n_devices`` equal to the
    world size. With no process group it runs at ``n_devices == 1`` in a
    world of one (NCCL on a card, gloo with ``device="cpu"``), which it
    ends before it returns. Synchronises ``device`` and returns None."""
    import torch.distributed as dist

    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices != world:
        raise ValueError(
            f"dryrun_multichip({n_devices}) in a world of {world}: start one process per rank "
            f"(e.g. torchrun --nproc-per-node={n_devices}), call parallel.initialize_distributed() on each "
            "and pass the world size"
        )
    created = not dist.is_initialized()
    try:
        tf, _ = _dryrun_parts(n_devices, dev)["tournament_icp"]
        if tuple(tf.linear.shape) != (3, 3):
            raise AssertionError(f"tournament ICP gave a {tuple(tf.linear.shape)} linear part")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    finally:
        if created and dist.is_initialized():
            dist.destroy_process_group()
