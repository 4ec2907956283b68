"""Point-sharded non-rigid (EDG) warp-field estimation (port of
``cilantro_tpu/parallel/sharded_warp.py``).

The warp's Gauss-Newton system separates across the ``points`` axis:

* point-aligned operands (source points, correspondence targets, normals
  and weights, each point's anchors and anchor weights) are split, each
  rank holding a block of rows;
* node-aligned state (node transforms and positions, the arcs, the CG or
  dense normal system: a few thousand nodes at most) is whole on every
  rank;
* every sum from point rows into node slots is followed by one reduction
  over ``points``: the anchor sums of Jᵀv (the CG matvec's point term),
  of the preconditioner and of the scatter assembly. The JAX module lets
  the SPMD partitioner insert those collectives; here the solver of
  :mod:`..registration.warp_field` takes them as its ``psum`` hook, a sum
  in rank order (:func:`.collectives.psum_ordered`), so every rank holds
  the same node state to the bit and leaves the GN, CG and ICP loops at
  the same iteration.

The graph's flattened-anchor sort is a permutation over all N·K point rows,
which sharding would scatter across ranks: a sharded graph keeps identity
anchor caches (``caches_sorted=False``) and its anchor sums scatter, as
the JAX module's ``_replicate_sort_caches`` arranges. Each rank's anchor
sum is computed once and gathered, so all ranks add the same parts; the
arc sums, which every rank computes itself, stay sorted reductions
(deterministic) so that the ranks agree to the bit.

Arguments are the whole problem (numpy or tensors) on every rank; each
rank cuts its own rows (the point count must divide the axis size: pad
with zero-weight rows first). Results are whole on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..core.transforms import Transform
from ..registration.warp_field import (
    DeformationGraph,
    _with_segment_lengths,
    estimate_warp_field,
    icp_warp_field,
)
from . import collectives as cc
from .sharded import mesh_device, shard_rows


def _replicate_sort_caches(g: DeformationGraph) -> DeformationGraph:
    """Identity anchor caches and no pair-assembly caches: the anchor sums
    then scatter, and the direct solver takes the scatter assembly. The
    arcs are whole on every rank, so their sums keep sorted reductions
    (the sort and the lengths counted here, on the host): a scatter-add's
    atomics would give each rank other bits of the same node system."""
    dev = g.anchors.device
    m = g.num_nodes
    arc_i, arc_j = g.arc_i.cpu().numpy().astype(np.int64), g.arc_j.cpu().numpy().astype(np.int64)
    if np.any(np.diff(arc_i) < 0):
        raise ValueError("arc_i must be sorted (build_deformation_graph and build_dense_graph sort it)")
    jorder = np.argsort(arc_j, kind="stable")
    g = _with_segment_lengths(dataclasses.replace(
        g,
        anchor_order=torch.arange(g.anchors.numel(), dtype=torch.int32, device=dev),
        anchor_sorted_ids=g.anchors.reshape(-1),
        arc_j_order=torch.as_tensor(jorder.astype(np.int32), device=dev),
        arc_j_sorted=torch.as_tensor(arc_j[jorder].astype(np.int32), device=dev),
        caches_sorted=False,
        pair_order=None, pair_seg_ids=None, pair_uniq_keys=None,
        ps_kkf=None, ps_llf=None, ps_w2=None, ps_swap=None, ps_seg=None,
        arc_sorted_order=None, arc_sorted_seg=None,
    ))
    return dataclasses.replace(
        g,
        arc_i_lengths=torch.as_tensor(np.bincount(arc_i, minlength=m), device=dev),
        arc_j_lengths=torch.as_tensor(np.bincount(arc_j, minlength=m), device=dev),
    )


def _point_sum(mesh: DeviceMesh, axis: str):
    return lambda x: cc.psum_ordered(x, mesh, axis)


def shard_warp_problem(
    mesh: DeviceMesh,
    graph: DeformationGraph,
    src_points,
    dst_points,
    dst_normals,
    corr_weights,
    *,
    axis: str = "points",
):
    """This rank's part of a warp problem: the graph with its
    point-aligned fields (anchors, anchor weights) cut to this rank's rows
    and identity sort caches, its node-aligned fields whole; and this
    rank's rows of ``src``, ``dst``, the normals and the weights, all on
    the mesh's device. Returns ``(graph, src, dst, nrm, w)`` for
    :func:`sharded_estimate_warp_field`'s solver."""
    dev = mesh_device(mesh)
    g = graph.to(dev)
    g = dataclasses.replace(
        g,
        anchors=shard_rows(g.anchors, mesh, axis),
        anchor_weights=shard_rows(g.anchor_weights, mesh, axis),
    )
    g = _replicate_sort_caches(g)
    src = shard_rows(src_points, mesh, axis)
    dst = shard_rows(dst_points, mesh, axis)
    nrm = None if dst_normals is None else shard_rows(dst_normals, mesh, axis)
    w = shard_rows(corr_weights, mesh, axis)
    return g, src, dst, nrm, w


def sharded_icp_warp_field(
    graph: DeformationGraph,
    src_points,
    dst_points,
    *,
    mesh: DeviceMesh,
    axis: str = "points",
    dst_normals=None,
    src_valid=None,
    dst_valid=None,
    **kwargs,
):
    """The sparse (EDG) non-rigid ICP over a mesh: the source points (and
    the graph's point-aligned state) split over ``axis``, the destination
    cloud and the node system whole on every rank. Each rank searches its
    source rows against the whole destination (the compact nn1 kernel
    through the prune plan on the card). Same arguments and results as
    :func:`..registration.warp_field.icp_warp_field` (``solver`` defaults
    to ``"cg"``)."""
    n = src_points.shape[0]
    if src_valid is None:
        src_valid = torch.ones(n, dtype=torch.bool)
    src_valid = torch.as_tensor(src_valid).to(torch.float32)
    g, src, _, _, sv = shard_warp_problem(mesh, graph, src_points, src_points, None, src_valid, axis=axis)
    dev = src.device
    kwargs.setdefault("solver", "cg")
    kwargs.setdefault("device", dev)

    def whole(a, dtype=None):
        return None if a is None else torch.as_tensor(a, dtype=dtype).to(dev)

    return icp_warp_field(
        g, src, whole(dst_points), dst_normals=whole(dst_normals), src_valid=sv > 0.5,
        dst_valid=whole(dst_valid, torch.bool), psum=_point_sum(mesh, axis), **kwargs,
    )


def sharded_estimate_warp_field(
    graph: DeformationGraph,
    src_points,
    dst_points,
    dst_normals,
    corr_weights,
    *,
    mesh: DeviceMesh,
    axis: str = "points",
    **kwargs,
) -> Tuple[Transform, torch.Tensor, torch.Tensor]:
    """Multi-rank :func:`..registration.warp_field.estimate_warp_field`:
    the same arguments and results, with the point-term work (anchor
    gathers, Jacobian products, the sums into nodes) split across ``mesh``
    and the node state whole on every rank (``solver`` defaults to
    ``"cg"``: matrix-free, one reduction a matvec)."""
    g, src, dst, nrm, w = shard_warp_problem(
        mesh, graph, src_points, dst_points, dst_normals, corr_weights, axis=axis,
    )
    kwargs.setdefault("solver", "cg")
    kwargs.setdefault("device", src.device)
    return estimate_warp_field(g, src, dst, nrm, w, psum=_point_sum(mesh, axis), **kwargs)
