"""Batched non-rigid warp-field solves: B targets against one shared
deformation graph (port of ``cilantro_tpu/registration/warp_field_batched.py``).

Every graph-indexed operation's indices (anchors, arcs, the pair-block
runs) are shared across the streams, so B solves ride the same gathers and
segment sums with B-times wider rows, and the B dense normal systems are
factored as one batched ``(B, 6M, 6M)`` Cholesky.

Scope (checked): rigid 3-D nodes, the direct solver, a graph with the pair
caches of this problem's shape. Other configurations take B
:func:`.warp_field.icp_warp_field` calls.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import resolve_device
from ..core.segment import sorted_sum
from ..core.transforms import Transform, axis_angle_to_rotation, project_to_rotation
from .warp_field import (
    _ASSEMBLY_CHUNK,
    DeformationGraph,
    _direct_solve,
    _huber_weights,
    _on,
    _outer_loop,
    _row_blocks,
    _triu_pairs,
    closed_form_entries,
    finish_normal_matrix,
    narrow_inputs,
    node_motion,
    write_pair_blocks,
)


def identity_warp_batched(bsz: int, num_nodes: int, device="cuda") -> Transform:
    dev = resolve_device(device)
    return Transform(
        torch.eye(3, device=dev).expand(bsz, num_nodes, 3, 3),
        torch.zeros((bsz, num_nodes, 3), device=dev),
    )


def _nodes_wide(node_tf: Transform) -> torch.Tensor:
    """(B, M, …) per-node transforms → one node-leading row array
    ``(M, B·12)`` (linear then translation), so that every graph gather is
    one gather of wide rows."""
    bsz, m = node_tf.translation.shape[:2]
    lin = node_tf.linear.permute(1, 0, 2, 3).reshape(m, bsz * 9)
    tr = node_tf.translation.permute(1, 0, 2).reshape(m, bsz * 3)
    return torch.cat([lin, tr], dim=1)


def _split_wide(pa: torch.Tensor, bsz: int):
    """A gathered ``(..., B·12)`` row → ``lin (..., B, 3, 3)``, ``tr (..., B, 3)``."""
    lead = pa.shape[:-1]
    return pa[..., : bsz * 9].reshape(lead + (bsz, 3, 3)), pa[..., bsz * 9:].reshape(lead + (bsz, 3))


def _warp_points_batched(graph, node_tf, points):
    bsz = node_tf.translation.shape[0]
    lin_a, tr_a = _split_wide(_nodes_wide(node_tf)[graph.anchors], bsz)
    y = torch.einsum("nkbij,nj->nkbi", lin_a, points) + tr_a
    return torch.einsum("nk,nkbi->nbi", graph.anchor_weights, y)


def warp_points_batched(
    graph: DeformationGraph, node_tf: Transform, points, device="cuda"
) -> torch.Tensor:
    """(B, M) transforms applied to the shared source points → ``(N, B, 3)``
    (the batch axis after the point axis keeps the anchor gather one
    gather)."""
    dev = resolve_device(device)
    tf = Transform(_on(node_tf.linear, dev), _on(node_tf.translation, dev))
    return _warp_points_batched(graph.to(dev), tf, _on(points, dev))


def _check_pair_caches(graph: DeformationGraph, n: int) -> None:
    """The pair caches are laid out for one (N, K, A): a graph built from
    another cloud would gather the wrong rows (JAX's length gate, as a hard
    error)."""
    if graph.pair_order is None:
        raise ValueError(
            "estimate_warp_field_batched needs the pair caches (a graph of at "
            "most 2048 nodes built by build_deformation_graph)"
        )
    k = graph.anchors.shape[1]
    t_blocks = k * (k + 1) // 2
    n_pad = max(1, -(-n // _ASSEMBLY_CHUNK)) * _ASSEMBLY_CHUNK
    expect = n_pad * t_blocks + 3 * graph.arc_i.shape[0]
    if graph.pair_order.shape[0] != expect:
        raise ValueError(
            f"pair caches were built for a different cloud/graph shape: "
            f"pair_order has {graph.pair_order.shape[0]} rows, this problem "
            f"needs {expect} (= {n_pad}*{t_blocks} pair rows + "
            f"3*{graph.arc_i.shape[0]} arc rows); rebuild the graph from the "
            f"source cloud passed here"
        )


def _batched_normal_matrix(graph, y, w_arc, y_jl, y_ll, w_pp, w_pl, nrm, plane_terms, stiffness,
                           levenberg):
    """The B dense damped normal matrices ``(B, 6M, 6M)``: the sorted
    narrow-input assembly where the graph has its caches for this shape,
    else the pair-cache route (closed-form blocks of every point, gathered
    by ``pair_order``)."""
    n, k, bsz = y.shape[:3]
    m = graph.num_nodes
    sa = (stiffness * w_arc)[..., None, None]  # (A, B, 1, 1)
    b_i = _row_blocks(y_jl, False)  # (A, B, 3, 6) = [−[y]× | I]
    b_j = -_row_blocks(y_ll, False)
    off = sa * torch.einsum("abdp,abdq->abpq", b_i, b_j)
    off = torch.where((graph.arc_i > graph.arc_j)[:, None, None, None], off.transpose(-1, -2), off)
    arc_vals = torch.cat(
        [
            (0.5 * sa * torch.einsum("abdp,abdq->abpq", b_i, b_i)).reshape(-1, bsz * 36),
            (0.5 * sa * torch.einsum("abdp,abdq->abpq", b_j, b_j)).reshape(-1, bsz * 36),
            off.reshape(-1, bsz * 36),
        ]
    )
    kk, ll = _triu_pairs(k, y.device)
    if (
        graph.ps_kkf is not None and graph.ps_kkf.shape[0] == n * len(kk)
        and graph.arc_sorted_order is not None and graph.arc_sorted_order.shape[0] == arc_vals.shape[0]
    ):
        ytab = narrow_inputs(y, w_pp, w_pl, nrm)  # (N·K, B·8)
        ga = ytab[graph.ps_kkf].view(-1, bsz, 8)
        gb = ytab[graph.ps_llf].view(-1, bsz, 8)
        vals = graph.ps_w2[:, None, None] * closed_form_entries(ga, gb, graph.ps_swap, plane_terms)
        compact = sorted_sum(vals.reshape(-1, bsz * 36), graph.ps_seg_lengths)
        compact = compact + sorted_sum(arc_vals[graph.arc_sorted_order], graph.arc_sorted_lengths)
    else:
        n_pad = max(1, -(-n // _ASSEMBLY_CHUNK)) * _ASSEMBLY_CHUNK
        pad = n_pad - n

        def padded(a):
            return torch.cat([a, a.new_zeros((pad,) + a.shape[1:])]) if pad else a

        y_p, wa_p, an_p = padded(y), padded(graph.anchor_weights), padded(graph.anchors)
        ytab = narrow_inputs(y_p, padded(w_pp), padded(w_pl), padded(nrm)).view(n_pad, k, bsz, 8)
        swap = (an_p[:, kk] > an_p[:, ll]).reshape(-1)
        ent = closed_form_entries(
            ytab[:, kk].reshape(-1, bsz, 8), ytab[:, ll].reshape(-1, bsz, 8), swap, plane_terms
        )
        half_diag = torch.where(kk == ll, 0.5, 1.0).to(y.dtype)
        ww = (wa_p[:, kk] * wa_p[:, ll] * half_diag).reshape(-1)
        vals = torch.cat([(ww[:, None, None] * ent).reshape(-1, bsz * 36), arc_vals])
        compact = sorted_sum(vals[graph.pair_order], graph.pair_seg_lengths)
    h = y.new_zeros((bsz, m * 6, m * 6))
    write_pair_blocks(h, graph, compact, 6)
    return finish_normal_matrix(h, graph.node_valid, levenberg, 6)


def _batched_gn_step(graph, node_tf, src_points, dst_points, nrm, w_pp, w_pl, plane_terms, *,
                     stiffness, huber_delta, levenberg):
    """One batched GN iteration: ``(new transforms, max update (B,))``.
    Never waits on the host."""
    bsz = node_tf.translation.shape[0]
    m = graph.num_nodes
    n, k = graph.anchors.shape
    wide = _nodes_wide(node_tf)  # one gather per index set
    lin_a, tr_a = _split_wide(wide[graph.anchors], bsz)
    y = torch.einsum("nkbij,nj->nkbi", lin_a, src_points) + tr_a  # (N, K, B, 3)
    wa = graph.anchor_weights
    x = torch.einsum("nk,nkbi->nbi", wa, y)

    cl = graph.node_positions[graph.arc_j]
    li, ti = _split_wide(wide[graph.arc_i], bsz)
    lj, tj = _split_wide(wide[graph.arc_j], bsz)
    y_jl = torch.einsum("abij,aj->abi", li, cl) + ti  # (A, B, 3)
    y_ll = torch.einsum("abij,aj->abi", lj, cl) + tj
    r_arc0 = y_jl - y_ll
    h = _huber_weights(torch.linalg.vector_norm(r_arc0, dim=-1), huber_delta)
    w_arc = (graph.arc_mask * graph.node_valid[graph.arc_i] * graph.node_valid[graph.arc_j])[:, None] * h

    r_pp0 = x - dst_points  # (N, B, 3)
    r_pl0 = torch.einsum("nbi,nbi->nb", nrm, r_pp0)
    # rhs = −Jᵀ r: the data rows through one shared segment reduction.
    g = w_pp[..., None] * r_pp0 + (w_pl * r_pl0)[..., None] * nrm
    gk = wa[:, :, None, None] * g[:, None]  # (N, K, B, 3)
    rows = torch.cat([torch.linalg.cross(y, gk, dim=-1), gk], dim=-1)  # (N, K, B, 6)
    acc = graph.segment_over_anchors(rows.reshape(n, k, bsz * 6))
    ga = (stiffness * w_arc)[..., None] * r_arc0
    rows_i = torch.cat([torch.linalg.cross(y_jl, ga, dim=-1), ga], -1)
    rows_j = torch.cat([-torch.linalg.cross(y_ll, ga, dim=-1), -ga], -1)
    acc = acc + graph.segment_over_arc_i(rows_i.reshape(-1, bsz * 6))
    acc = acc + graph.segment_over_arc_j(rows_j.reshape(-1, bsz * 6))
    rhs = -acc.reshape(m, bsz, 6).permute(1, 0, 2)  # (B, M, 6)

    h_mat = _batched_normal_matrix(
        graph, y, w_arc, y_jl, y_ll, w_pp, w_pl, nrm, plane_terms, stiffness, levenberg
    )
    delta = _direct_solve(h_mat, rhs.contiguous())  # (B, M, 6)
    dw, dt = delta[..., :3], delta[..., 3:]
    lin_inc = axis_angle_to_rotation(dw.reshape(-1, 3)).reshape(bsz, m, 3, 3)
    new_lin = torch.einsum("bmij,bmjk->bmik", lin_inc, node_tf.linear)
    new_tr = torch.einsum("bmij,bmj->bmi", lin_inc, node_tf.translation) + dt
    new_tf = Transform(project_to_rotation(new_lin.reshape(-1, 3, 3)).reshape(bsz, m, 3, 3), new_tr)
    upd = torch.amax(
        torch.where(graph.node_valid[None, :], torch.linalg.vector_norm(delta, dim=-1), 0.0), dim=1
    )
    return new_tf, upd


def estimate_warp_field_batched(
    graph: DeformationGraph,
    src_points,  # (N, 3) shared source
    dst_points,  # (N, B, 3) per-stream gathered targets
    dst_normals,  # (N, B, 3) or None
    corr_weights,  # (N, B), 0 = no correspondence
    *,
    init: Optional[Transform] = None,  # batched (B, M, …)
    point_weight: float = 0.0,
    plane_weight: float = 1.0,
    stiffness: float = 200.0,
    huber_delta: float = 1e-2,
    max_gn_iterations: int = 1,
    levenberg: float = 1e-6,
    device="cuda",
) -> Tuple[Transform, torch.Tensor]:
    """One-to-B twin of :func:`.warp_field.estimate_warp_field` (rigid 3-D,
    direct solver). Returns ``(node transforms (B, M, …), max per-stream GN
    update (B,))``."""
    dev = resolve_device(device)
    graph = graph.to(dev)
    src_points, dst_points = _on(src_points, dev), _on(dst_points, dev)
    dst_normals, corr_weights = _on(dst_normals, dev), _on(corr_weights, dev)
    n, d = src_points.shape
    if d != 3:
        raise ValueError(f"estimate_warp_field_batched is rigid 3-D only (got D={d})")
    _check_pair_caches(graph, n)
    bsz = corr_weights.shape[1]
    node_tf = (
        Transform(_on(init.linear, dev), _on(init.translation, dev))
        if init is not None
        else identity_warp_batched(bsz, graph.num_nodes, device=dev)
    )
    nrm = dst_normals if dst_normals is not None else torch.zeros((n, bsz, d), device=dev)
    upd = torch.full((bsz,), float("inf"), dtype=src_points.dtype, device=dev)
    for _ in range(max_gn_iterations):
        node_tf, upd = _batched_gn_step(
            graph, node_tf, src_points, dst_points, nrm, corr_weights * point_weight,
            corr_weights * plane_weight, dst_normals is not None, stiffness=stiffness,
            huber_delta=huber_delta, levenberg=levenberg,
        )
    return node_tf, upd


def _icp_batched_impl(
    graph, src_points, dst_points_b, dst_normals_b, src_valid, dst_valid_b, point_weight,
    plane_weight, stiffness, huber_delta, convergence_tol, max_corr_dist_sq, *, max_iterations,
    max_gn_iterations, with_normals,
):
    from ..neighbors.bruteforce import INVALID_DIST, nn1
    from ..neighbors.fused_nn import maybe_make_nn1_prune_plan, nn1_pruned_planned

    bsz, n, _ = dst_points_b.shape
    dev = src_points.device
    # One prune plan per stream, built once: each stream has its own keys.
    plans = [
        maybe_make_nn1_prune_plan(
            dst_points_b[b], max_corr_dist_sq, src_points,
            key_valid=None if dst_valid_b is None else dst_valid_b[b], query_valid=src_valid,
        )
        for b in range(bsz)
    ]
    use_planned = all(p is not None for p in plans)

    def step(node_tf):
        warped = _warp_points_batched(graph, node_tf, src_points)
        dgt, ngt, ws = [], [], []
        for b in range(bsz):
            q = warped[:, b]
            if use_planned:
                dist, idx = nn1_pruned_planned(q, plans[b])
            else:
                dist, idx = nn1(q, dst_points_b[b],
                                key_valid=None if dst_valid_b is None else dst_valid_b[b])
            mask = (dist <= max_corr_dist_sq) & (dist < INVALID_DIST * 0.5) & src_valid
            safe = torch.where(mask, idx, 0).long()
            dgt.append(dst_points_b[b][safe])
            if with_normals:
                ngt.append(dst_normals_b[b][safe])
            ws.append(mask.to(src_points.dtype))
        new_tf, _ = estimate_warp_field_batched(
            graph, src_points, torch.stack(dgt, dim=1),
            torch.stack(ngt, dim=1) if with_normals else None, torch.stack(ws, dim=1),
            init=node_tf, point_weight=point_weight, plane_weight=plane_weight,
            stiffness=stiffness, huber_delta=huber_delta, max_gn_iterations=max_gn_iterations,
            device=dev,
        )
        return new_tf, node_motion(new_tf, node_tf, graph.node_valid[None, :])

    # All streams iterate in lockstep until every one has converged.
    return _outer_loop(
        step, identity_warp_batched(bsz, graph.num_nodes, device=dev), max_iterations,
        convergence_tol, dev,
    )


def icp_warp_field_batched(
    graph: DeformationGraph,
    src_points,  # (N, 3) shared template
    dst_points_b,  # (B, N, 3) per-stream targets
    *,
    dst_normals_b=None,
    src_valid=None,
    dst_valid_b=None,  # (B, N) per-stream key masks
    max_corr_dist_sq: float = 0.0025,
    point_weight: float = 0.1,
    plane_weight: float = 1.0,
    stiffness: float = 200.0,
    huber_delta: float = 1e-2,
    max_iterations: int = 15,
    convergence_tol: float = 2.5e-3,
    max_gn_iterations: int = 1,
    device="cuda",
) -> Tuple[Transform, torch.Tensor, torch.Tensor]:
    """B-stream twin of :func:`.warp_field.icp_warp_field`: one shared
    template and graph registered to B target clouds. ``dst_valid_b`` masks
    invalid rows of each stream's target out of its NN search. The
    per-stream NN searches (one prune plan each) run one after the other,
    the GN solve is one :func:`estimate_warp_field_batched`, and all
    streams iterate until every stream's node motion drops below the
    tolerance. Returns ``(transforms (B, M, …), iterations, converged
    (B,))``."""
    dev = resolve_device(device)
    graph = graph.to(dev)
    src_points, dst_points_b = _on(src_points, dev), _on(dst_points_b, dev)
    dst_normals_b = _on(dst_normals_b, dev)
    src_valid, dst_valid_b = _on(src_valid, dev, torch.bool), _on(dst_valid_b, dev, torch.bool)
    if src_valid is None:
        src_valid = torch.ones(src_points.shape[0], dtype=torch.bool, device=dev)
    return _icp_batched_impl(
        graph, src_points, dst_points_b, dst_normals_b, src_valid, dst_valid_b, point_weight,
        plane_weight, stiffness, huber_delta, convergence_tol, max_corr_dist_sq,
        max_iterations=max_iterations, max_gn_iterations=max_gn_iterations,
        # Plane terms need real normals: with none, the plane rows are off
        # whatever plane_weight says (the single solver's dst_normals=None).
        with_normals=dst_normals_b is not None and plane_weight != 0.0,
    )
