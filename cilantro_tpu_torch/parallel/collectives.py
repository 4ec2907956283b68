"""The collectives of the sharded paths, on a mesh's per-axis process
groups. The sharded modules use nothing else of ``torch.distributed``.

A JAX ``shard_map`` body is the code each rank runs on its own shard; its
collectives map to calls on the groups of the named mesh axes:

=================  ============================================
JAX                here
=================  ============================================
``psum``           :func:`psum` (disjoint parts) or
                   :func:`psum_ordered` (replicated small sums)
``pmin``           :func:`pmin` (``all_reduce`` with ``MIN``)
``all_gather``     :func:`all_gather`
``ppermute`` ring  :func:`ring_shift` (``batch_isend_irecv``)
``axis_index``     :func:`axis_index`
=================  ============================================

Replicated state must be bit-identical on every rank: a loop whose exit
depends on the data would otherwise end at different iterations on two
ranks, and the next collective would wait until the group's timeout. JAX's
SPMD gives that by construction; here every replicated sum of partial
values (normal equations, camera vectors, node systems) is
:func:`psum_ordered`: each rank's part is gathered and the parts are added
in rank order, so the bits depend neither on the backend nor on how it
reduces. An ``all_reduce`` sum (:func:`psum`) is kept for sums whose parts
are disjoint (one nonzero part an element: ``x + 0`` is exact), and every
loop exit is decided from values that came out of a collective.

Backends: NCCL for one card a rank, gloo for ranks on the CPU or several
ranks on one card. Gloo's transport runs through the host, and its
``all_gather`` and point-to-point calls take CPU tensors only: on a gloo
group those two stage a CUDA buffer through host memory (a copy out
before and a copy back after; the computation stays on the card). Gloo's
``all_reduce`` and ``broadcast`` take CUDA tensors as they are. NCCL
groups never stage.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str]]


def _axes(axes: Axes):
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_group(mesh, axis: str):
    """The process group of ``mesh``'s ``axis`` that holds this rank."""
    return mesh.get_group(axis)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (JAX's ``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def _staged(group, x: torch.Tensor) -> bool:
    """Whether a gloo group's gather or point-to-point needs ``x`` staged
    through host memory."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def psum(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Sum over ``axes`` with one ``all_reduce`` an axis. Only for parts
    that are disjoint (each element nonzero on at most one rank), where
    every order of the adds gives the same bits."""
    out = x.contiguous().clone()
    for axis in _axes(axes):
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=axis_group(mesh, axis))
    return out


def pmin(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Elementwise minimum over ``axis`` (exact, order-free)."""
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MIN, group=axis_group(mesh, axis))
    return out


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, stacked in rank order: ``(D,) +
    x.shape``."""
    group = axis_group(mesh, axis)
    n = dist.get_world_size(group)
    staged = _staged(group, x)
    src = (x.cpu() if staged else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.stack(parts)
    return out.to(x.device) if staged else out


def psum_ordered(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Sum over ``axes``, each axis's parts gathered and added in rank
    order: the same bits on every rank, whatever the backend."""
    out = x
    for axis in _axes(axes):
        parts = all_gather(out, mesh, axis)
        acc = parts[0]
        for part in parts[1:]:
            acc = acc + part
        out = acc
    return out


def ring_shift(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """JAX's ``ppermute`` with ``perm = [(i, (i + 1) % D)]``: send ``x`` to
    the next rank on ``axis``, return what the previous one sent. One rank
    keeps its own ``x``."""
    group = axis_group(mesh, axis)
    n = dist.get_world_size(group)
    if n == 1:
        return x
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    staged = _staged(group, x)
    send = (x.cpu() if staged else x).contiguous()
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, nxt, group),
        dist.P2POp(dist.irecv, recv, prv, group),
    ])
    for req in reqs:
        req.wait()
    return recv.to(x.device) if staged else recv


def broadcast(x: torch.Tensor, mesh, axis: str, src: int = 0) -> torch.Tensor:
    """``x`` of the rank at coordinate ``src`` on ``axis``, on every rank
    of it."""
    group = axis_group(mesh, axis)
    out = x.contiguous().clone()
    dist.broadcast(out, src=dist.get_global_rank(group, src), group=group)
    return out


def broadcast_object(obj, mesh, axis: str, src: int = 0):
    """A picklable object of the rank at coordinate ``src`` on ``axis``
    (host arrays: numpy travels as bytes), on every rank of it."""
    group = axis_group(mesh, axis)
    box = [obj]
    dev = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend(group) == "nccl" else None
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, src), group=group, device=dev)
    return box[0]


def isend(x: torch.Tensor, mesh, axis: str, dst: int):
    """Start sending ``x`` to the rank at coordinate ``dst`` on ``axis``;
    returns a ``wait()`` callable (the send buffer stays alive until it
    is called)."""
    group = axis_group(mesh, axis)
    buf = (x.cpu() if _staged(group, x) else x).contiguous()
    work = dist.isend(buf, dist.get_global_rank(group, dst), group=group)

    def wait(_buf=buf):
        work.wait()

    return wait


def irecv(shape, dtype, device, mesh, axis: str, src: int):
    """Start receiving a ``shape`` / ``dtype`` tensor from the rank at
    coordinate ``src`` on ``axis``; returns a callable that waits and
    gives the tensor on ``device``."""
    group = axis_group(mesh, axis)
    device = torch.device(device)
    host = device.type == "cuda" and dist.get_backend(group) == "gloo"
    buf = torch.empty(shape, dtype=dtype, device="cpu" if host else device)
    work = dist.irecv(buf, dist.get_global_rank(group, src), group=group)

    def finish():
        work.wait()
        return buf.to(device) if host else buf

    return finish
