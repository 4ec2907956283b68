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
Two cards (the JAX module's two devices) are not supported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.coalesced import launch_counts as coalesced_launch_counts
from ..core.rgbd import CameraIntrinsics, depth_to_points_normals
from ..core.transforms import Transform, identity
from ..core.transforms import launch_counts as transforms_launch_counts
from .driver import FusionMetrics
from .fusion import FusionConfig, FusionMap, fusion_step, init_map_from_frame, seed_localize_target
from .scan import RUNS, scan


def make_pipeline_mesh(devices=None) -> Tuple[torch.device, torch.device]:
    """The two stages' devices ``(front end, tracker)``: the first two of
    ``devices``, or the default card for both when it is None. Both stages
    on one card run on two CUDA streams of it; on the CPU they run in
    order. Fewer than two devices raise ``ValueError``, as the JAX
    module's mesh does; two different devices raise
    ``NotImplementedError``."""
    if devices is None:
        devices = [resolve_device()] * 2
    devices = list(devices)
    if len(devices) < 2:
        raise ValueError("pipeline parallelism needs at least 2 devices")
    front, tracker = (resolve_device(d) for d in devices[:2])
    if front != tracker:
        raise NotImplementedError(
            f"stages on {front} and {tracker}: the port runs both stages on one device"
        )
    return front, tracker


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
    (CUDA events, ``None`` on the CPU) and ``launches_per_frame``."""
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
