"""Pipelined fusion: the frame front end beside the tracker / integrator
(port of ``cilantro_tpu/slam/pipeline.py``).

A fusion step's localize needs the map that the previous integrate left,
so the solve cannot be split across frames; the front end (depth →
points + pixel-neighbour normals, :func:`..core.rgbd.depth_to_points_normals`)
needs only its frame. So the sequence runs as two stages a step:

    stage 0: preprocess frame t             (front end)
    stage 1: localize + integrate frame t−1 (tracker / mapper)

The JAX module puts the stages on two devices of a mesh and hands the
preprocessed frame from one to the other with a ``ppermute``. On one card
the stages are two CUDA streams of it: stage 0 runs on a side stream
forked from the step's stream and joined back before the step ends, and
the handoff is a device copy of stage 0's output into the in-flight
buffer that stage 1 reads on the next step. One such step is captured in a
CUDA graph and replayed once a frame (:func:`.scan.scan`). On the CPU the
stages run in order. Stage 1 is :func:`.fusion.fusion_step` with the
graph loop form on the inputs :func:`.driver.run_fusion_sequence_scanned`
gives it, so the two drivers give the same poses and pool, bit for bit.

On two ranks (a ``("pipe",)`` mesh of :func:`make_pipeline_mesh`, one
process a device, as the JAX module's two devices) rank 0 runs the front
end and rank 1 the tracker: each preprocessed frame goes across by
point-to-point (rank 0 runs ahead by as many frames as it likes; rank 1
posts the receive of the next frame before it fuses the current one),
and rank 1's trajectory, ICP iterations and pool are broadcast back, so
both ranks return them, as the JAX module's psum does. That form runs
eagerly, with the same tracker step on the same inputs.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import resolve_device
from ..core.coalesced import launch_counts as coalesced_launch_counts
from ..core.rgbd import CameraIntrinsics, depth_to_points_normals
from ..core.transforms import Transform, identity
from ..core.transforms import launch_counts as transforms_launch_counts
from .driver import FusionMetrics
from .fusion import FusionConfig, FusionMap, fusion_step, init_map_from_frame, seed_localize_target
from .scan import RUNS, scan


def make_pipeline_mesh(
    devices=None, *, timeout=None
) -> Union[Tuple[torch.device, torch.device], DeviceMesh, None]:
    """Where the two stages run. In a process group of two or more ranks
    (or given such a ``DeviceMesh`` with the one axis ``"pipe"``): a
    ``("pipe",)`` mesh over ranks 0 and 1, the front end on rank 0 and the
    tracker on rank 1; ranks past 1 take part in making its group and get
    None (the JAX module leaves devices past its first two idle).
    Otherwise the stages' devices ``(front end,
    tracker)`` in this process: the first two of ``devices``, or the
    default card for both when it is None; both stages on one card run on
    two CUDA streams of it, on the CPU in order. Fewer than two devices
    raise ``ValueError``, as the JAX module's mesh does; two different
    devices in one process raise ``NotImplementedError``. ``timeout``
    (default :data:`..parallel.distributed.DEFAULT_TIMEOUT`) bounds the
    two-rank group's waits."""
    if isinstance(devices, DeviceMesh):
        if devices.mesh_dim_names != ("pipe",) or devices.size() != 2:
            raise ValueError(f"a two-rank pipeline takes a ('pipe',) mesh of 2 ranks, not {devices}")
        return devices
    if devices is None and dist.is_initialized() and dist.get_world_size() >= 2:
        return _rank_mesh(timeout)
    if devices is None:
        devices = [resolve_device()] * 2
    devices = list(devices)
    if len(devices) < 2:
        raise ValueError("pipeline parallelism needs at least 2 devices")
    front, tracker = (resolve_device(d) for d in devices[:2])
    if front != tracker:
        raise NotImplementedError(
            f"stages on {front} and {tracker} in one process: run one process a device "
            "(e.g. torchrun --nproc-per-node=2) and pass make_pipeline_mesh()'s two-rank mesh"
        )
    return front, tracker


def _rank_mesh(timeout=None) -> Optional[DeviceMesh]:
    """A ``("pipe",)`` mesh over ranks 0 and 1 of the process group, None
    on the other ranks (every rank calls it: it makes a group)."""
    from ..parallel.distributed import DEFAULT_TIMEOUT

    group = dist.new_group([0, 1], timeout=timeout or DEFAULT_TIMEOUT)
    if dist.get_rank() >= 2:
        return None
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh.from_group(group, device_type, mesh=[0, 1], mesh_dim_names=("pipe",))


def run_fusion_sequence_pipelined(
    depths: Sequence[np.ndarray],
    intrinsics: CameraIntrinsics,
    *,
    mesh: Optional[Tuple[torch.device, torch.device]] = None,
    map_capacity: Optional[int] = None,
    cfg: FusionConfig = FusionConfig(),
    device="cuda",
    stats: Optional[dict] = None,
) -> Tuple[FusionMap, FusionMetrics]:
    """Whole-sequence fusion as a two-stage pipeline on ``mesh``'s device
    (:func:`make_pipeline_mesh` of ``device`` twice when None). Returns what
    :func:`.driver.run_fusion_sequence_scanned` returns, with the same
    poses, ICP iterations and pool; ``seconds_per_frame`` is a step of the
    fastest of 3 runs by the host clock (capture and a first run excluded).
    Frame 1 is preprocessed before the first step (the pipeline's fill),
    each step fuses one frame, and the last one preprocesses a zero drain
    frame. ``stats``, if given, receives ``device_seconds_per_frame``
    (CUDA events, ``None`` on the CPU) and ``launches_per_frame``.

    Given a two-rank ``("pipe",)`` mesh, every rank of it calls this; the
    stages run on the two ranks (:func:`_run_two_ranks`), each on its own
    ``device``."""
    if isinstance(mesh, DeviceMesh):
        return _run_two_ranks(depths, intrinsics, make_pipeline_mesh(mesh), map_capacity, cfg, stats,
                              resolve_device(device))
    dev = (mesh or make_pipeline_mesh([device, device]))[1]
    h, w = depths[0].shape
    if map_capacity is None:
        map_capacity = 4 * h * w
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
    # Frames 2..F-1 and one zero drain frame; frame 1 fills the pipeline.
    drain = np.zeros((1, h, w), np.float32)
    xs = torch.as_tensor(
        np.concatenate([np.asarray(depths[2:], np.float32).reshape(-1, h, w), drain]), device=dev
    )
    pose0 = identity(3, device=dev)
    _, packed0 = seed_localize_target(fmap0, pose0, intrinsics, h, w)
    inflight0 = depth_to_points_normals(
        torch.as_tensor(np.asarray(depths[1], np.float32), device=dev), intrinsics
    )
    side = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None

    def front_end(depth):
        return depth_to_points_normals(depth, intrinsics)

    def tracker(data, linear, translation, packed, p, n, v):
        fmap, pose, res, _, packed = fusion_step(
            FusionMap(data=data), p, n, None, v, Transform(linear, translation), intrinsics,
            cached_packed_target=packed, height=h, width=w, cfg=cfg, loop="graph",
        )
        return (fmap.data, pose.linear, pose.translation, packed), (pose.matrix(), res.iterations)

    def step(carry, depth):
        p, n, v = carry[4:]
        if side is None:
            nxt = front_end(depth)
            state, ys = tracker(*carry[:4], p, n, v)
        else:
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                nxt = front_end(depth)
            state, ys = tracker(*carry[:4], p, n, v)
            torch.cuda.current_stream(dev).wait_stream(side)
        # The handoff: stage 0's frame becomes the next step's in-flight
        # frame (scan copies the new carry onto the old).
        return state + tuple(nxt), ys

    out = scan(
        step, (fmap0.data, pose0.linear, pose0.translation, packed0) + tuple(inflight0), xs,
        counters=(coalesced_launch_counts, transforms_launch_counts), runs=RUNS,
    )
    fmap = FusionMap(data=out.carry[0])
    mats, iterations = out.ys
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


def _run_two_ranks(depths, intrinsics, mesh: DeviceMesh, map_capacity, cfg, stats, dev):
    """The two-rank form: rank 0 preprocesses frames 1..F-1 and sends each
    as one ``(H·W, 7)`` buffer (points, normals, valid); rank 1 fuses them
    with the scanned driver's step, eagerly; then rank 1 broadcasts the
    poses, iterations and pool. ``seconds_per_frame`` is this rank's host
    clock over its stage; ``stats`` receives ``rank`` and
    ``stage_seconds``."""
    from ..parallel import collectives as cc

    me = cc.axis_index(mesh, "pipe")
    h, w = depths[0].shape
    if map_capacity is None:
        map_capacity = 4 * h * w

    def frame(f):
        return depth_to_points_normals(torch.as_tensor(np.asarray(depths[f], np.float32), device=dev),
                                       intrinsics)

    p0, n0, v0 = frame(0)
    fmap0 = init_map_from_frame(map_capacity, p0, n0, None, v0)
    n_fuse = len(depths) - 1
    mats = torch.zeros((n_fuse, 4, 4), dtype=torch.float32, device=dev)
    iterations = torch.zeros((n_fuse,), dtype=torch.int32, device=dev)
    data = fmap0.data
    t0 = time.perf_counter()
    if me == 0:  # the front end
        waits = []
        for f in range(1, len(depths)):
            p, n, v = frame(f)
            waits.append(cc.isend(torch.cat([p, n, v.to(torch.float32)[:, None]], dim=1), mesh, "pipe", 1))
        for wait in waits:
            wait()
    elif n_fuse:  # the tracker
        pose = identity(3, device=dev)
        _, packed = seed_localize_target(fmap0, pose, intrinsics, h, w)

        def post():
            return cc.irecv((h * w, 7), torch.float32, dev, mesh, "pipe", 0)

        pending = post()
        for i in range(n_fuse):
            buf = pending()
            if i + 1 < n_fuse:
                pending = post()
            fmap, pose, res, _, packed = fusion_step(
                FusionMap(data=data), buf[:, 0:3], buf[:, 3:6], None, buf[:, 6] > 0.5, pose, intrinsics,
                cached_packed_target=packed, height=h, width=w, cfg=cfg, loop="graph",
            )
            data = fmap.data
            mats[i] = pose.matrix()
            iterations[i] = res.iterations
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stage_s = time.perf_counter() - t0
    # The tracker's results go back to both ranks.
    mats, iterations, data = (cc.broadcast(x, mesh, "pipe", src=1) for x in (mats, iterations, data))
    fmap = FusionMap(data=data)
    if stats is not None:
        stats.update(rank=me, stage_seconds=stage_s)
    return fmap, FusionMetrics(
        poses=[np.eye(4, dtype=np.float32)] + list(mats.cpu().numpy()),
        frames=len(depths),
        seconds_per_frame=stage_s / max(n_fuse, 1),
        icp_iterations=[0] + [int(i) for i in iterations.cpu()],
        num_map_points=int(fmap.num_points()),
    )
