"""Multi-device SPMD registration over a 2-D mesh of ranks (port of
``cilantro_tpu/parallel/sharded.py``).

The mesh has two axes, as the JAX module's:

* ``points``: data parallelism over source / query points;
* ``map``: the destination ("map") cloud split across ranks, so that a map
  larger than one card still gets an exact nearest-neighbour search.

Each rank runs the body of the JAX module's ``shard_map`` program on its
own shard (one rank a device, :mod:`.distributed`). An ICP iteration:

1. each rank finds its queries' best neighbour in its map shard, exactly
   (:func:`.fused_nn.nn1_fused`, ties to the smallest index) and takes the
   winner's payload (dst point ‖ dst normal) by its index;
2. the candidates are gathered along ``map`` and the least distance wins (a
   k = 1 tournament), or, in the ring form, query blocks travel round the
   ``points`` ring while the map shards stay put;
3. the 6×6 + 6 normal equations are summed over the mesh in rank order
   (:func:`.collectives.psum_ordered`), so every rank solves the same
   system to the same bits and leaves the loop at the same iteration;
4. the 6-DoF step is solved on every rank.

Arguments sharded in JAX are this rank's shard here (:func:`shard_cloud_arrays`
cuts them); replicated arguments and results are whole on every rank.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import resolve_device
from ..core.transforms import Transform, axis_angle_to_rotation, compose, identity, reproject_rigid
from ..neighbors.bruteforce import INVALID_DIST
from ..neighbors.fused_nn import nn1_fused
from ..registration.icp import _delta_norm
from ..registration.transform_estimation import _gn_accumulate_3d, _solve_normal_equations
from . import collectives as cc
from .distributed import DEFAULT_TIMEOUT

_EPS = 1e-12
MESH_AXES = ("points", "map")


def make_mesh(
    n_points_shards: Optional[int] = None,
    n_map_shards: int = 1,
    devices: Optional[Sequence[int]] = None,
    *,
    device="cuda",
    timeout=DEFAULT_TIMEOUT,
) -> DeviceMesh:
    """A ``(points, map)`` :class:`DeviceMesh` over the ranks ``devices``
    (default every rank, in order), laid out row-major as the JAX
    module's device grid. Each axis gets its own process groups, made here
    with ``timeout``. With no process group yet, a world of one is made:
    NCCL when ``device`` is a card, gloo for ``device="cpu"``, so that a
    single process runs every sharded entry point. Call it on every rank
    in the same order (it makes groups)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, timeout=timeout)
    ranks = list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]
    if n_points_shards is None:
        n_points_shards = len(ranks) // n_map_shards
    if n_points_shards * n_map_shards != len(ranks):
        raise ValueError(f"a {n_points_shards}x{n_map_shards} mesh over {len(ranks)} ranks")
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(n_points_shards, n_map_shards)
    map_groups = [grid[i, :].tolist() for i in range(n_points_shards)]
    points_groups = [grid[:, j].tolist() for j in range(n_map_shards)]
    map_group, _ = dist.new_subgroups_by_enumeration(map_groups, timeout=timeout)
    points_group, _ = dist.new_subgroups_by_enumeration(points_groups, timeout=timeout)
    return DeviceMesh.from_group([points_group, map_group], dev.type, mesh=grid,
                                 mesh_dim_names=MESH_AXES)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shards live on: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_rows(a, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """This rank's block of the leading dimension of ``a`` (numpy or a
    tensor) along ``axis``, on :func:`mesh_device`."""
    dev = mesh_device(mesh)
    t = torch.as_tensor(a)
    n, d = t.shape[0], cc.axis_size(mesh, axis)
    if n % d:
        raise ValueError(f"{n} rows do not divide the {d} shards of {axis!r}")
    i, rows = cc.axis_index(mesh, axis), n // d
    return t[i * rows:(i + 1) * rows].to(dev).contiguous()


def _local_nn_payload(q, keys, payload, key_valid):
    """Best key per query within this shard: ``(dist, payload row)``, the
    payload zero where no key is valid. ``payload`` carries what the
    winner contributes downstream (dst point ‖ dst normal), so no
    cross-shard index gather is needed."""
    d, idx = nn1_fused(q, keys, key_valid=key_valid)
    found = d < INVALID_DIST
    return d, torch.where(found[:, None], payload[idx.long()], 0.0)


def _icp_gn_loop(
    src, sv, nn_fn: Callable, psum: Callable, *, max_iterations, convergence_tol, max_corr_dist_sq,
    point_weight, plane_weight,
):
    """The ICP Gauss-Newton loop of the tournament and the ring:
    ``nn_fn(s) -> (best_d, payload[dst | dst_normal])``, the normal
    equations reduced by ``psum``, an arctan-damped axis-angle update and
    SO(3) re-projection. The exit reads the update norm, which every rank
    computed from the same reduced system."""
    dev = src.device
    tf = identity(3, dtype=src.dtype, device=dev)
    it, dn = 0, float("inf")
    while it < max_iterations and dn >= convergence_tol:
        s = tf.apply(src)
        best_d, best_p = nn_fn(s)
        w = (sv & (best_d <= max_corr_dist_sq)).to(s.dtype)
        jtj, jtr = _gn_accumulate_3d(s, best_p[:, :3], best_p[:, 3:], w * point_weight, w * plane_weight)
        system = psum(torch.cat([jtj.reshape(-1), jtr]))
        step = _solve_normal_equations(system[:36].reshape(6, 6), system[36:], 6)
        omega, t = step[:3], step[3:]
        theta = torch.linalg.vector_norm(omega)
        scale = torch.where(theta > _EPS, torch.arctan(theta) / torch.clamp(theta, min=_EPS), 1.0)
        delta = Transform(axis_angle_to_rotation(omega * scale), t)
        tf = reproject_rigid(compose(delta, tf))
        dn = float(_delta_norm(delta))
        it += 1
    return tf, torch.tensor(it, dtype=torch.int32, device=dev)


def _payload(dst, dn):
    return torch.cat([dst, dn], dim=1)


def sharded_combined_icp(
    src_points,
    src_valid,
    dst_points,
    dst_normals,
    dst_valid,
    *,
    mesh: DeviceMesh,
    max_iterations: int = 15,
    convergence_tol: float = 1e-5,
    max_corr_dist_sq: float = 0.0001,
    point_weight: float = 0.0,
    plane_weight: float = 1.0,
) -> Tuple[Transform, torch.Tensor]:
    """Fully sharded rigid combined-metric ICP (3-D): this rank's block of
    ``src (N/P, 3)`` (sharded over ``points``) and of ``dst_* (M/Q, 3)``
    (over ``map``). Returns the replicated final transform and iteration
    count."""
    payload = _payload(dst_points, dst_normals)

    def nn_fn(s):
        d_loc, p_loc = _local_nn_payload(s, dst_points, payload, dst_valid)
        # k = 1 tournament across the map axis: one gather of (dist | payload).
        both = cc.all_gather(torch.cat([d_loc[:, None], p_loc], dim=1), mesh, "map")
        win = torch.argmin(both[..., 0], dim=0)
        rows = torch.arange(s.shape[0], device=s.device)
        best = both[win, rows]
        return best[:, 0], best[:, 1:]

    return _icp_gn_loop(
        src_points, src_valid, nn_fn, lambda x: cc.psum_ordered(x, mesh, MESH_AXES),
        max_iterations=max_iterations, convergence_tol=convergence_tol,
        max_corr_dist_sq=max_corr_dist_sq, point_weight=point_weight, plane_weight=plane_weight,
    )


def sharded_combined_icp_ring(
    src_points,
    src_valid,
    dst_points,
    dst_normals,
    dst_valid,
    *,
    mesh: DeviceMesh,
    max_iterations: int = 15,
    convergence_tol: float = 1e-5,
    max_corr_dist_sq: float = 0.0001,
    point_weight: float = 0.0,
    plane_weight: float = 1.0,
) -> Tuple[Transform, torch.Tensor]:
    """Large-map rigid ICP: both clouds shard over ``points`` and no rank
    holds more than one shard of either; the :func:`ring_nn1` rotation
    replaces the tournament's gather. Memory a rank: O(N/D + M/D); an
    iteration sends D hops of the query block and sums one 6×6 system."""
    payload = _payload(dst_points, dst_normals)

    def nn_fn(s):
        return _ring_nn1_program(s, src_valid, dst_points, payload, dst_valid, mesh, "points")

    return _icp_gn_loop(
        src_points, src_valid, nn_fn, lambda x: cc.psum_ordered(x, mesh, "points"),
        max_iterations=max_iterations, convergence_tol=convergence_tol,
        max_corr_dist_sq=max_corr_dist_sq, point_weight=point_weight, plane_weight=plane_weight,
    )


def shard_cloud_arrays(mesh: DeviceMesh, axis: str, *arrays):
    """This rank's block of each array's leading dimension along ``axis``
    (numpy or tensors; the row count must divide the axis size: padding is
    the caller's), on the mesh's device."""
    return tuple(shard_rows(a, mesh, axis) for a in arrays)


# ---------------------------------------------------------------------------
# Ring-rotation NN: the ring-attention analogue for neighbour search.
# ---------------------------------------------------------------------------


def _ring_nn1_program(q, qv, mp, pay, mv, mesh: DeviceMesh, axis: str):
    """The ring body: D steps, each a local search of the visiting query
    block against this rank's map shard and one shift of the block with its
    running best to the next rank, so each block is home after a lap."""
    n = cc.axis_size(mesh, axis)
    width = q.shape[1]
    best_d = torch.full((q.shape[0],), INVALID_DIST, dtype=q.dtype, device=q.device)
    best_p = torch.zeros((q.shape[0], pay.shape[1]), dtype=pay.dtype, device=q.device)
    qb = q
    for _ in range(n):
        d_loc, p_loc = _local_nn_payload(qb, mp, pay, mv)
        better = d_loc < best_d
        best_d = torch.where(better, d_loc, best_d)
        best_p = torch.where(better[:, None], p_loc, best_p)
        block = cc.ring_shift(torch.cat([qb, best_d[:, None], best_p], dim=1), mesh, axis)
        qb, best_d, best_p = block[:, :width], block[:, width], block[:, width + 1:]
    return torch.where(qv, best_d, INVALID_DIST), best_p


def ring_nn1(
    queries,
    query_valid,
    map_points,
    map_payload,
    map_valid,
    *,
    mesh: DeviceMesh,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact sharded NN without replication: query blocks travel round the
    ``points`` ring (one ``batch_isend_irecv`` a step) while map shards stay
    put; each block's running best travels with it and is home after a
    lap. All five arguments are this rank's blocks. Returns this rank's
    ``(dist (Q/D,), payload (Q/D, P))``, ``INVALID_DIST`` where nothing
    matched."""
    return _ring_nn1_program(queries, query_valid, map_points, map_payload, map_valid, mesh, "points")
