"""Non-rigid warp-field estimation, dense and on an embedded deformation
graph (port of ``cilantro_tpu/registration/warp_field.py``).

Each source point is attached to ``k_anchors`` control nodes with fixed
weights and the regularisation arcs come from a fixed node kNN graph, so
the sparsity is structural: Jᵀ(J·x) is evaluated matrix-free with gathers
and segment sums, and the direct solver assembles the dense normal matrix
from per-pair blocks whose reduction order is fixed when the graph is
built. The arithmetic follows the JAX module expression for expression.

Sums over graph rows are sorted segment reductions
(``torch.segment_reduce`` over lengths counted once at graph build) rather
than ``index_add_``: on CUDA the latter adds with atomics, so its bits
change from run to run, while a segment reduction adds each segment in
order. Two direct solves of one problem on the card give the same bits.

JAX's ``lax.while_loop`` s are host loops here with one host read an outer
ICP iteration (and one a GN iteration past the first). One direct GN step
(:func:`_gn_step`) never waits on the host. The CG solver runs in chunks
of :data:`_CG_CHUNK` iterations with a device flag that freezes the
iterates once JAX's loop condition fails, so its iterates and iteration
count equal a loop that tests the condition before every iteration; the
host reads the flag once a chunk.

Every entry point takes ``device`` (default the card, through
:func:`..resolve_device`); array arguments may be numpy arrays or tensors
and are moved there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.transforms import (
    Transform,
    axis_angle_to_rotation,
    compose,
    project_to_rotation,
    skew3,
)
from ..neighbors.api import knn_search

_EPS = 1e-12
_ASSEMBLY_CHUNK = 4096  # the pair caches' point padding (JAX's scan chunk)
_CG_CHUNK = 16  # CG iterations between two host reads of the loop flag


def _on(x, dev, dtype=None):
    """``x`` (numpy array or tensor, or None) as a tensor on ``dev``."""
    return None if x is None else torch.as_tensor(x, dtype=dtype, device=dev)


def sorted_sum(values, lengths):
    """Sums of consecutive runs of ``values`` rows, one per entry of
    ``lengths`` (0 for an empty run), each run added in order:
    deterministic on every device. ``unsafe`` skips the lengths checks,
    which read back to the host; the lengths come from the graph build."""
    return torch.segment_reduce(values, "sum", lengths=lengths, axis=0, unsafe=True)


def _segment_sum(values, seg_ids, lengths, num_segments):
    """Sum of ``values`` rows per segment: with ``lengths`` the rows are
    sorted by segment (:func:`sorted_sum`); without, scattered by
    ``seg_ids`` (unsorted caches)."""
    if lengths is not None:
        return sorted_sum(values, lengths)
    out = values.new_zeros((num_segments,) + values.shape[1:])
    return out.index_add_(0, seg_ids.long(), values)


@dataclasses.dataclass(frozen=True)
class DeformationGraph:
    """Fixed-sparsity embedded deformation graph.

    ``node_positions (M, D)``; ``anchors (N, K)`` node ids per source point
    with normalized weights ``anchor_weights (N, K)`` (0 rows for invalid
    points); regularization arcs ``arc_i/arc_j (A,)`` with ``arc_mask``.
    The sort and pair-block caches are JAX's (see its dataclass); the
    ``*_lengths`` fields and ``pair_uniq_count`` are the port's own,
    counted from them once (:func:`_with_segment_lengths`).
    """

    node_positions: torch.Tensor
    node_valid: torch.Tensor
    anchors: torch.Tensor
    anchor_weights: torch.Tensor
    arc_i: torch.Tensor
    arc_j: torch.Tensor
    arc_mask: torch.Tensor
    anchor_order: torch.Tensor  # (N·K,) permutation sorting the flat anchors
    anchor_sorted_ids: torch.Tensor  # (N·K,) node ids, ascending
    arc_j_order: torch.Tensor  # (A,) permutation sorting arc_j
    arc_j_sorted: torch.Tensor  # (A,) ascending
    # False where the caches above are identity permutations (a sharded
    # graph): the segment sums then scatter.
    caches_sorted: bool = True
    # Direct-solver pair-block caches (None for a graph past 2048 nodes).
    pair_order: Optional[torch.Tensor] = None  # (R,) permutation
    pair_seg_ids: Optional[torch.Tensor] = None  # (R,) ascending run ids
    pair_uniq_keys: Optional[torch.Tensor] = None  # (U_pad,) keys, ≥ m·m = pad
    # Sorted narrow-input caches (rigid 3-D direct solver).
    ps_kkf: Optional[torch.Tensor] = None  # (R1,) pt*K + kk[t], key-sorted
    ps_llf: Optional[torch.Tensor] = None  # (R1,) pt*K + ll[t]
    ps_w2: Optional[torch.Tensor] = None  # (R1,) wa_k*wa_l*half_diag
    ps_swap: Optional[torch.Tensor] = None  # (R1,) bool: node_k > node_l
    ps_seg: Optional[torch.Tensor] = None  # (R1,) ascending segment ids
    arc_sorted_order: Optional[torch.Tensor] = None  # (3A,) arc-row sort
    arc_sorted_seg: Optional[torch.Tensor] = None  # (3A,) ascending seg ids
    # Segment lengths of the sorted ids above (int64), and the number of
    # real keys in pair_uniq_keys: its pad keys sort after them.
    anchor_lengths: Optional[torch.Tensor] = None  # (M,)
    arc_i_lengths: Optional[torch.Tensor] = None  # (M,)
    arc_j_lengths: Optional[torch.Tensor] = None  # (M,)
    pair_seg_lengths: Optional[torch.Tensor] = None  # (U_pad,)
    ps_seg_lengths: Optional[torch.Tensor] = None  # (U_pad,)
    arc_sorted_lengths: Optional[torch.Tensor] = None  # (U_pad,)
    pair_uniq_count: int = 0

    @property
    def num_nodes(self) -> int:
        return self.node_positions.shape[0]

    def to(self, device) -> "DeformationGraph":
        """The same graph with every tensor on ``device``."""
        dev = torch.device(device)
        moved = {
            f.name: getattr(self, f.name).to(dev)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        return dataclasses.replace(self, **moved)

    def segment_over_anchors(self, values: torch.Tensor) -> torch.Tensor:
        """Σ over anchors per node; ``values (N, K, ...)`` → ``(M, ...)``."""
        flat = values.reshape((values.shape[0] * values.shape[1],) + values.shape[2:])
        lengths = self.anchor_lengths if self.caches_sorted else None
        return _segment_sum(
            flat[self.anchor_order], self.anchor_sorted_ids, lengths, self.num_nodes
        )

    def segment_over_arc_j(self, values: torch.Tensor) -> torch.Tensor:
        lengths = self.arc_j_lengths if self.caches_sorted else None
        return _segment_sum(values[self.arc_j_order], self.arc_j_sorted, lengths, self.num_nodes)

    def segment_over_arc_i(self, values: torch.Tensor) -> torch.Tensor:
        """Σ over arcs per source node (``arc_i`` is sorted by construction)."""
        return _segment_sum(values, self.arc_i, self.arc_i_lengths, self.num_nodes)


def build_deformation_graph(
    src_points,
    node_positions,
    *,
    src_valid=None,
    node_valid=None,
    k_anchors: int = 4,
    k_arcs: int = 8,
    weight_sigma: Optional[float] = None,
    device="cuda",
) -> DeformationGraph:
    """Attach each source point to its ``k_anchors`` nearest control nodes
    with normalized RBF weights (``icp_warp_field_combined_metric_sparse`` /
    ``non_rigid_icp.cpp:53-58``); arcs = node k-NN pairs."""
    dev = resolve_device(device)
    src_points, node_positions = _on(src_points, dev), _on(node_positions, dev)
    src_valid, node_valid = _on(src_valid, dev, torch.bool), _on(node_valid, dev, torch.bool)
    nb = knn_search(
        src_points, node_positions, k_anchors, query_valid=src_valid, key_valid=node_valid
    )
    d2 = torch.where(nb.mask, nb.distances, 0.0)
    if weight_sigma is None:
        # The reference uses an RBF at the control resolution; a robust
        # default is the per-point max anchor distance.
        sigma2 = torch.clamp(torch.amax(d2, dim=1, keepdim=True), min=_EPS)
    else:
        sigma2 = float(np.float32(weight_sigma) ** 2)
    w = torch.exp(-0.5 * d2 / sigma2) * nb.mask
    w = w / torch.clamp(torch.sum(w, dim=1, keepdim=True), min=_EPS)

    arcs = knn_search(
        node_positions, node_positions, k_arcs, query_valid=node_valid, key_valid=node_valid,
        exclude_self=True,
    )
    m = node_positions.shape[0]
    if node_valid is None:
        node_valid = torch.ones(m, dtype=torch.bool, device=dev)
    return _with_sort_caches(
        _bare_graph(
            node_positions, node_valid, nb.indices, w,
            torch.arange(m, dtype=torch.int32, device=dev).repeat_interleave(k_arcs),
            arcs.indices.reshape(-1), arcs.mask.reshape(-1),
        )
    )


def _bare_graph(node_positions, node_valid, anchors, weights, arc_i, arc_j, arc_mask):
    empty = torch.zeros(0, dtype=torch.int32, device=node_positions.device)
    return DeformationGraph(
        node_positions=node_positions, node_valid=node_valid, anchors=anchors,
        anchor_weights=weights, arc_i=arc_i, arc_j=arc_j, arc_mask=arc_mask,
        anchor_order=empty, anchor_sorted_ids=empty, arc_j_order=empty, arc_j_sorted=empty,
    )


def _pair_assembly_caches(g: DeformationGraph):
    """Host-side static pair-block sort caches (numpy; see the dataclass
    fields), a copy of JAX's: ``(order, seg_ids, uniq_keys_padded,
    sorted_caches)``, or None past 2048 nodes (the direct solver never runs
    there, and m·m would not fit int32)."""
    m = g.num_nodes
    if m > 2048:
        return None
    anchors = g.anchors.cpu().numpy()
    arc_i = g.arc_i.cpu().numpy().astype(np.int64)
    arc_j = g.arc_j.cpu().numpy().astype(np.int64)
    n, k = anchors.shape
    kk, ll = np.triu_indices(k)  # the assembly's double-loop order
    chunk = _ASSEMBLY_CHUNK
    n_pad = max(1, -(-n // chunk)) * chunk
    a_pad = np.zeros((n_pad, k), np.int64)
    a_pad[:n] = anchors
    an, bn = a_pad[:, kk], a_pad[:, ll]
    pair_keys = (np.minimum(an, bn) * m + np.maximum(an, bn)).reshape(-1)
    arc_keys = np.concatenate(
        [
            arc_i * m + arc_i,
            arc_j * m + arc_j,
            np.minimum(arc_i, arc_j) * m + np.maximum(arc_i, arc_j),
        ]
    )
    keys = np.concatenate([pair_keys, arc_keys])
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    new_run = np.empty(len(sk), bool)
    new_run[0] = True
    new_run[1:] = sk[1:] != sk[:-1]
    seg = np.cumsum(new_run) - 1
    uniq = sk[new_run]
    u_pad = max(8, -(-len(uniq) // 8) * 8)
    # Distinct pad keys past every real key.
    uniq_p = m * m + np.arange(u_pad, dtype=np.int64)
    uniq_p[: len(uniq)] = uniq

    # Sorted narrow-input caches: the unpadded point-pair stream (n·T rows)
    # sorted by key, the static weight product folded in, and the arc
    # stream's own sort into the same segment list.
    wa = g.anchor_weights.cpu().numpy().astype(np.float64)
    an_u, bn_u = anchors[:, kk], anchors[:, ll]  # (n, T)
    keys_u = np.minimum(an_u, bn_u) * m + np.maximum(an_u, bn_u)
    order_u = np.argsort(keys_u.reshape(-1), kind="stable")
    pt = order_u // len(kk)
    t = order_u % len(kk)
    hd = np.where(kk == ll, 0.5, 1.0)
    ps_w2 = (wa[pt, kk[t]] * wa[pt, ll[t]] * hd[t]).astype(np.float32)
    ps_seg = np.searchsorted(uniq, keys_u.reshape(-1)[order_u]).astype(np.int32)
    arc_order3 = np.argsort(arc_keys, kind="stable")
    arc_seg3 = np.searchsorted(uniq, arc_keys[arc_order3]).astype(np.int32)
    sorted_caches = (
        (pt * k + kk[t]).astype(np.int32),
        (pt * k + ll[t]).astype(np.int32),
        ps_w2,
        anchors[pt, kk[t]] > anchors[pt, ll[t]],
        ps_seg,
        arc_order3.astype(np.int32),
        arc_seg3,
    )
    return order.astype(np.int32), seg.astype(np.int32), uniq_p.astype(np.int32), sorted_caches


def _with_sort_caches(g: DeformationGraph) -> DeformationGraph:
    dev = g.node_positions.device
    flat = g.anchors.reshape(-1)
    order = torch.argsort(flat, stable=True)
    jorder = torch.argsort(g.arc_j, stable=True)
    pair = _pair_assembly_caches(g)

    def t(a):
        return torch.as_tensor(a, device=dev)

    sc = [t(a) for a in pair[3]] if pair else [None] * 7
    return _with_segment_lengths(
        dataclasses.replace(
            g,
            anchor_order=order.to(torch.int32),
            anchor_sorted_ids=flat[order],
            arc_j_order=jorder.to(torch.int32),
            arc_j_sorted=g.arc_j[jorder],
            pair_order=t(pair[0]) if pair else None,
            pair_seg_ids=t(pair[1]) if pair else None,
            pair_uniq_keys=t(pair[2]) if pair else None,
            ps_kkf=sc[0], ps_llf=sc[1], ps_w2=sc[2], ps_swap=sc[3], ps_seg=sc[4],
            arc_sorted_order=sc[5], arc_sorted_seg=sc[6],
        )
    )


def _with_segment_lengths(g: DeformationGraph) -> DeformationGraph:
    """Fill the port's segment lengths and ``pair_uniq_count`` from the
    sorted caches (counted on the host: ``torch.bincount`` on CUDA reads
    its maximum back, so it runs once here and never in a solve)."""
    dev = g.node_positions.device
    m = g.num_nodes

    def lengths(ids, n_seg):
        if ids is None:
            return None
        counts = np.bincount(ids.cpu().numpy().astype(np.int64), minlength=n_seg)
        return torch.as_tensor(counts, dtype=torch.int64, device=dev)

    n_seg = 0 if g.pair_uniq_keys is None else g.pair_uniq_keys.shape[0]
    count = 0
    if g.pair_uniq_keys is not None:
        count = int((g.pair_uniq_keys.cpu().numpy().astype(np.int64) < m * m).sum())
    return dataclasses.replace(
        g,
        anchor_lengths=lengths(g.anchor_sorted_ids, m) if g.caches_sorted else None,
        arc_i_lengths=lengths(g.arc_i, m) if g.caches_sorted else None,
        arc_j_lengths=lengths(g.arc_j_sorted, m) if g.caches_sorted else None,
        pair_seg_lengths=lengths(g.pair_seg_ids, n_seg),
        ps_seg_lengths=lengths(g.ps_seg, n_seg),
        arc_sorted_lengths=lengths(g.arc_sorted_seg, n_seg),
        pair_uniq_count=count,
    )


def identity_warp(num_nodes: int, dim: int = 3, device="cuda") -> Transform:
    dev = resolve_device(device)
    return Transform(
        torch.eye(dim, device=dev).expand(num_nodes, dim, dim),
        torch.zeros((num_nodes, dim), device=dev),
    )


def _nodes_packed(node_tf: Transform) -> torch.Tensor:
    """Per-node transforms packed as one ``(M, D·D + D)`` row array (linear
    then translation), so that a graph gather is one gather of rows."""
    m, d = node_tf.translation.shape
    return torch.cat([node_tf.linear.reshape(m, d * d), node_tf.translation], dim=1)


def _split_packed(pa: torch.Tensor, d: int):
    """Gathered packed rows → ``(lin (..., D, D), tr (..., D))``."""
    lin = pa[..., : d * d].reshape(pa.shape[:-1] + (d, d))
    return lin, pa[..., d * d:]


def _warp_points(graph: DeformationGraph, node_tf: Transform, points: torch.Tensor) -> torch.Tensor:
    d = node_tf.translation.shape[1]
    lin, tr = _split_packed(_nodes_packed(node_tf)[graph.anchors], d)  # (N, K, D, D), (N, K, D)
    w = graph.anchor_weights
    blended_lin = torch.einsum("nk,nkij->nij", w, lin)
    blended_tr = torch.einsum("nk,nki->ni", w, tr)
    return torch.einsum("nij,nj->ni", blended_lin, points) + blended_tr


def warp_points(
    graph: DeformationGraph, node_tf: Transform, points, device="cuda"
) -> torch.Tensor:
    """Blend node transforms per point and apply: the dense-field application
    of ``resampleTransforms`` fused with ``transformPoints``."""
    dev = resolve_device(device)
    tf = Transform(_on(node_tf.linear, dev), _on(node_tf.translation, dev))
    return _warp_points(graph.to(dev), tf, _on(points, dev))


def resample_transforms(
    node_tf: Transform,
    neighborhood_idx,
    neighborhood_weights,
    rigid: bool = True,
    device="cuda",
) -> Transform:
    """Weighted blend of node transforms onto arbitrary targets, rotation
    re-projection for rigid fields (``warp_field_utilities.hpp:14-48``)."""
    dev = resolve_device(device)
    idx = _on(neighborhood_idx, dev).long()
    w = _on(neighborhood_weights, dev)
    lin = torch.einsum("nk,nkij->nij", w, _on(node_tf.linear, dev)[idx])
    tr = torch.einsum("nk,nki->ni", w, _on(node_tf.translation, dev)[idx])
    if rigid:
        lin = project_to_rotation(lin)
    return Transform(lin, tr)


# ---------------------------------------------------------------------------
# Gauss-Newton solver (matrix-free block-sparse normal equations).
# ---------------------------------------------------------------------------


def _huber_weights(r_norm, delta):
    """IRLS weights for the sqrt-Huber loss on arc residual norms
    (``warp_field_estimation.hpp:10-36``)."""
    return torch.where(r_norm <= delta, 1.0, delta / torch.clamp(r_norm, min=_EPS))


def _perp(pts):
    return torch.stack([-pts[..., 1], pts[..., 0]], dim=-1)


@dataclasses.dataclass(frozen=True)
class _Terms:
    """One GN iteration's linearisation at δ = 0: warped anchor positions
    ``y (N, K, D)``, arc geometry, residuals and weights, with J·δ and
    Jᵀ·v over them."""

    graph: DeformationGraph
    y: torch.Tensor  # (N, K, D) = T_j(p_i)
    y_jl: torch.Tensor  # (A, D) = T_j(c_l)
    y_ll: torch.Tensor  # (A, D) = T_l(c_l)
    r_pp0: torch.Tensor  # (N, D)
    r_pl0: torch.Tensor  # (N,)
    r_arc0: torch.Tensor  # (A, D)
    w_arc: torch.Tensor  # (A,)
    w_pp: torch.Tensor  # (N,)
    w_pl: torch.Tensor  # (N,)
    normals: Optional[torch.Tensor]  # (N, D) or None
    stiffness: float
    affine: bool

    @property
    def d(self) -> int:
        return self.y.shape[-1]

    @property
    def n_lin(self) -> int:
        d = self.d
        return d * d if self.affine else (d if d == 3 else 1)

    def lin_apply(self, dl, pts):
        """The linear-part increment applied to points: rotation generators
        for rigid, full matrices for affine. ``dl (..., n_lin)``."""
        d = self.d
        if self.affine:
            return torch.einsum("...ij,...j->...i", dl.reshape(dl.shape[:-1] + (d, d)), pts)
        if d == 3:
            return torch.linalg.cross(dl, pts, dim=-1)
        return dl * _perp(pts)

    def lin_grad(self, g, pts):
        """(∂(linear-part increment · pts)/∂params)ᵀ g."""
        d = self.d
        if self.affine:
            return torch.einsum("...i,...j->...ij", g, pts).reshape(g.shape[:-1] + (d * d,))
        if d == 3:
            return torch.linalg.cross(pts, g, dim=-1)
        return torch.sum(_perp(pts) * g, dim=-1, keepdim=True)

    def j_apply(self, delta):
        """J·δ for all rows; ``delta (M, n_lin + D)``."""
        g, n_lin = self.graph, self.n_lin
        da = delta[g.anchors]  # (N, K, P)
        v = self.lin_apply(da[..., :n_lin], self.y) + da[..., n_lin:]
        v_pt = torch.einsum("nk,nki->ni", g.anchor_weights, v)
        if self.normals is not None:
            v_pl = torch.einsum("ni,ni->n", self.normals, v_pt)
        else:
            v_pl = torch.zeros_like(self.r_pl0)
        di, dj = delta[g.arc_i], delta[g.arc_j]
        va = (
            self.lin_apply(di[..., :n_lin], self.y_jl)
            + di[..., n_lin:]
            - self.lin_apply(dj[..., :n_lin], self.y_ll)
            - dj[..., n_lin:]
        )
        return v_pt, v_pl, va

    def jt_apply(self, v_pt, v_pl, va):
        """Jᵀ·[v] accumulated per node, ``(M, P)``."""
        g = self.graph
        rows = self.w_pp[:, None] * v_pt
        if self.normals is not None:
            rows = rows + (self.w_pl * v_pl)[:, None] * self.normals
        gk = g.anchor_weights[..., None] * rows[:, None, :]  # (N, K, D)
        acc = g.segment_over_anchors(torch.cat([self.lin_grad(gk, self.y), gk], dim=-1))
        ga = (self.stiffness * self.w_arc)[:, None] * va
        rows_i = torch.cat([self.lin_grad(ga, self.y_jl), ga], dim=-1)
        rows_j = torch.cat([-self.lin_grad(ga, self.y_ll), -ga], dim=-1)
        acc = acc + g.segment_over_arc_i(rows_i)
        return acc + g.segment_over_arc_j(rows_j)

    def rhs(self):
        return -self.jt_apply(self.r_pp0, self.r_pl0, self.r_arc0)


def _linearize(
    graph, node_tf, src_points, dst_points, dst_normals, w_pp, w_pl, *, stiffness, huber_delta,
    affine,
) -> _Terms:
    d = src_points.shape[1]
    lin_a, tr_a = _split_packed(_nodes_packed(node_tf)[graph.anchors], d)
    y = torch.einsum("nkij,nj->nki", lin_a, src_points) + tr_a  # (N, K, D)
    x = torch.einsum("nk,nki->ni", graph.anchor_weights, y)
    cl = graph.node_positions[graph.arc_j]
    y_jl = torch.einsum("aij,aj->ai", node_tf.linear[graph.arc_i], cl) + node_tf.translation[graph.arc_i]
    y_ll = torch.einsum("aij,aj->ai", node_tf.linear[graph.arc_j], cl) + node_tf.translation[graph.arc_j]
    r_arc0 = y_jl - y_ll
    h = _huber_weights(torch.linalg.vector_norm(r_arc0, dim=-1), huber_delta)
    w_arc = graph.arc_mask * h * graph.node_valid[graph.arc_i] * graph.node_valid[graph.arc_j]
    r_pp0 = x - dst_points
    if dst_normals is not None:
        r_pl0 = torch.einsum("ni,ni->n", dst_normals, r_pp0)
    else:
        r_pl0 = torch.zeros(src_points.shape[0], dtype=src_points.dtype, device=src_points.device)
    return _Terms(
        graph=graph, y=y, y_jl=y_jl, y_ll=y_ll, r_pp0=r_pp0, r_pl0=r_pl0, r_arc0=r_arc0,
        w_arc=w_arc, w_pp=w_pp, w_pl=w_pl, normals=dst_normals, stiffness=stiffness,
        affine=affine,
    )


def _row_blocks(pts, affine: bool):
    """Row-derivative block B = d(increment applied at pts)/d(params),
    ``(..., D, P)``, consistent with :meth:`_Terms.lin_apply`."""
    d = pts.shape[-1]
    eye_d = torch.eye(d, dtype=pts.dtype, device=pts.device)
    eye = eye_d.expand(pts.shape[:-1] + (d, d))
    if affine:
        blin = torch.einsum("rs,...c->...rsc", eye_d, pts)
        return torch.cat([blin.reshape(pts.shape[:-1] + (d, d * d)), eye], dim=-1)
    if d == 3:
        return torch.cat([-skew3(pts), eye], dim=-1)
    return torch.cat([_perp(pts)[..., None], eye], dim=-1)


def _arc_values(t: _Terms, arc_i, arc_j):
    """The arcs' oriented, half-diagonal blocks ``(3A, P·P)``: (i, i), (j,
    j), then (min, max) of every arc, the order of the arc keys."""
    sa = (t.stiffness * t.w_arc)[:, None, None]
    b_i = _row_blocks(t.y_jl, t.affine)
    b_j = -_row_blocks(t.y_ll, t.affine)
    pp = b_i.shape[-1] ** 2
    off = sa * torch.einsum("adp,adq->apq", b_i, b_j)
    off = torch.where((arc_i > arc_j)[:, None, None], off.transpose(-1, -2), off)
    return torch.cat(
        [
            (0.5 * sa * torch.einsum("adp,adq->apq", b_i, b_i)).reshape(-1, pp),
            (0.5 * sa * torch.einsum("adp,adq->apq", b_j, b_j)).reshape(-1, pp),
            off.reshape(-1, pp),
        ]
    )


def _triu_pairs(k: int, dev):
    """The anchor pairs (k ≤ l) in the assembly's double-loop order, made
    on ``dev`` (a copy from the host would wait on it)."""
    kk, ll = torch.triu_indices(k, k, device=dev)
    return kk, ll


def closed_form_entries(ga, gb, swap, with_normals: bool):
    """Rigid 3-D pair blocks ``w_pp·BkᵀBl + w_pl·(nᵀBk)ᵀ(nᵀBl)`` flattened
    to ``(..., 36)``, from the gathered narrow input rows ``ga``/``gb``
    ``(..., 8)`` = ``[y (3) | w_pp | w_pl | n (3)]`` of anchors k and l. A
    swapped pair (``swap (R,)``: node k > node l) is oriented upper-triangle
    by exchanging the two anchor streams: BlᵀBk = (BkᵀBl)ᵀ.
    BkᵀBl = [(yk·yl)I − yl ykᵀ, [yk]× ; −[yl]×, I]."""
    sw = swap.reshape(swap.shape + (1,) * (ga.dim() - swap.dim()))
    ya = torch.where(sw, gb[..., :3], ga[..., :3])
    yb = torch.where(sw, ga[..., :3], gb[..., :3])
    xk, yk, zk = ya.unbind(-1)
    xl, yl, zl = yb.unbind(-1)
    wpt, wplt = ga[..., 3], ga[..., 4]
    dot = xk * xl + yk * yl + zk * zl
    zero, one = torch.zeros_like(dot), torch.ones_like(dot)
    base = torch.stack(
        [
            dot - xl * xk, -xl * yk, -xl * zk, zero, -zk, yk,
            -yl * xk, dot - yl * yk, -yl * zk, zk, zero, -xk,
            -zl * xk, -zl * yk, dot - zl * zk, -yk, xk, zero,
            zero, zl, -yl, one, zero, zero,
            -zl, zero, xl, zero, one, zero,
            yl, -xl, zero, zero, zero, one,
        ],
        dim=-1,
    )
    ent = wpt[..., None] * base
    if with_normals:
        nx, ny, nz = ga[..., 5], ga[..., 6], ga[..., 7]
        bnk = torch.stack([yk * nz - zk * ny, zk * nx - xk * nz, xk * ny - yk * nx, nx, ny, nz], -1)
        bnl = torch.stack([yl * nz - zl * ny, zl * nx - xl * nz, xl * ny - yl * nx, nx, ny, nz], -1)
        ent = ent + ((wplt[..., None] * bnk)[..., :, None] * bnl[..., None, :]).flatten(-2)
    return ent


def narrow_inputs(y, w_pp, w_pl, nrm):
    """The 8-wide input table ``(N·K, [B·]8)`` the sorted assembly gathers:
    ``y (N, K, [B,] 3)`` beside the point's ``[w_pp | w_pl | n]``."""
    n, k = y.shape[:2]
    ptdata = torch.cat([w_pp[..., None], w_pl[..., None], nrm], dim=-1)  # (N, [B,] 5)
    tab = torch.cat([y, ptdata[:, None].expand(y.shape[:-1] + (5,))], dim=-1)
    return tab.reshape(n * k, -1)


def _pair_blocks(t: _Terms, n_rows: int):
    """Oriented, half-diagonal anchor-pair blocks of every point, point-major
    then pair (the pair caches' row order), padded with zero points to
    ``n_rows``: ``(n_rows·T, P·P)`` and their keys."""
    g = t.graph
    n, k = g.anchors.shape
    m = g.num_nodes
    pad = n_rows - n

    def padded(a):
        return torch.cat([a, a.new_zeros((pad,) + a.shape[1:])]) if pad else a

    y, wa, anchors = padded(t.y), padded(g.anchor_weights), padded(g.anchors)
    w_pp, w_pl = padded(t.w_pp), padded(t.w_pl)
    kk, ll = _triu_pairs(k, y.device)
    half_diag = torch.where(kk == ll, 0.5, 1.0).to(y.dtype)[:, None, None]
    bw = wa[..., None, None] * _row_blocks(y, t.affine)  # (N, K, D, P)
    bk, bl = bw[:, kk], bw[:, ll]
    pair = w_pp[:, None, None, None] * torch.einsum("ntdp,ntdq->ntpq", bk, bl)
    if t.normals is not None:
        bn = torch.einsum("nd,nkdp->nkp", padded(t.normals), bw)
        pair = pair + w_pl[:, None, None, None] * torch.einsum("ntp,ntq->ntpq", bn[:, kk], bn[:, ll])
    pair = pair * half_diag
    a_n, b_n = anchors[:, kk], anchors[:, ll]
    pair = torch.where((a_n > b_n)[..., None, None], pair.transpose(-1, -2), pair)
    keys = (torch.minimum(a_n, b_n) * m + torch.maximum(a_n, b_n)).reshape(-1)
    return pair.reshape(-1, pair.shape[-1] ** 2), keys


def direct_route(graph: DeformationGraph, n: int, d: int, affine: bool) -> str:
    """Which assembly the direct solver takes, by JAX's rules: ``"sorted"``
    (rigid 3-D, sorted narrow-input caches of this problem's shape),
    ``"pair"`` (pair caches of this shape) or ``"scatter"``."""
    k = graph.anchors.shape[1]
    t = k * (k + 1) // 2
    n_arc_rows = 3 * graph.arc_i.shape[0]
    n_pad = max(1, -(-n // _ASSEMBLY_CHUNK)) * _ASSEMBLY_CHUNK
    if (
        not affine and d == 3
        and graph.ps_kkf is not None and graph.ps_kkf.shape[0] == n * t
        and graph.arc_sorted_order is not None and graph.arc_sorted_order.shape[0] == n_arc_rows
        and graph.pair_uniq_keys is not None
    ):
        return "sorted"
    if graph.pair_order is not None and graph.pair_order.shape[0] == n_pad * t + n_arc_rows:
        return "pair"
    return "scatter"


def _blocks_view(h: torch.Tensor, m: int, p: int) -> torch.Tensor:
    """``h (..., M·P, M·P)`` viewed as ``(M, M, ..., P, P)`` node-pair
    blocks: writing a block writes ``h``."""
    lead = h.dim() - 2
    v = h.view(h.shape[:lead] + (m, p, m, p))
    return v.permute((lead, lead + 2) + tuple(range(lead)) + (lead + 1, lead + 3))


def write_pair_blocks(h, graph: DeformationGraph, compact, p: int):
    """Write the summed blocks of the occupied node pairs (``compact``, one
    row per key of ``pair_uniq_keys``; pad rows past ``pair_uniq_count``
    are dropped) into ``h``'s upper-triangle blocks."""
    m = graph.num_nodes
    count = graph.pair_uniq_count
    keys = graph.pair_uniq_keys[:count].long()
    blocks = _blocks_view(h, m, p)
    blocks[keys // m, keys % m] = compact[:count].view((count,) + blocks.shape[2:])


def finish_normal_matrix(h, node_valid, levenberg: float, p: int):
    """Symmetrize (each unordered block was stored once, diagonals halved),
    then damp, with a unit diagonal on dead nodes (their rhs is zero, so
    their δ stays zero; without it the system would be singular)."""
    h = h + h.transpose(-1, -2)
    diag = (levenberg + 1e-8) + torch.where(node_valid, 0.0, 1.0)
    h.diagonal(dim1=-2, dim2=-1).add_(diag.repeat_interleave(p))
    return h


def _normal_matrix(t: _Terms, levenberg: float) -> torch.Tensor:
    """The dense damped normal matrix ``(M·P, M·P)`` (the direct solver's
    assembly): each unordered anchor-pair block summed once per node pair
    in upper-triangle orientation, then symmetrized."""
    g = t.graph
    n, k = g.anchors.shape
    d, m = t.d, g.num_nodes
    p = t.n_lin + d
    arc_vals = _arc_values(t, g.arc_i, g.arc_j)
    h = t.y.new_zeros((m * p, m * p))
    route = direct_route(g, n, d, t.affine)
    if route == "sorted":
        nrm = t.normals if t.normals is not None else torch.zeros_like(t.r_pp0)
        ytab = narrow_inputs(t.y, t.w_pp, t.w_pl, nrm)
        vals = g.ps_w2[:, None] * closed_form_entries(
            ytab[g.ps_kkf], ytab[g.ps_llf], g.ps_swap, t.normals is not None
        )
        compact = sorted_sum(vals, g.ps_seg_lengths)
        compact = compact + sorted_sum(arc_vals[g.arc_sorted_order], g.arc_sorted_lengths)
        write_pair_blocks(h, g, compact, p)
    elif route == "pair":
        n_pad = max(1, -(-n // _ASSEMBLY_CHUNK)) * _ASSEMBLY_CHUNK
        pair, _ = _pair_blocks(t, n_pad)
        vals = torch.cat([pair, arc_vals])
        compact = sorted_sum(vals[g.pair_order], g.pair_seg_lengths)
        write_pair_blocks(h, g, compact, p)
    else:
        # Unordered scatter-add (graphs without pair caches).
        pair, keys = _pair_blocks(t, n)
        ai, aj = g.arc_i.long(), g.arc_j.long()
        arc_keys = torch.cat([ai * m + ai, aj * m + aj, torch.minimum(ai, aj) * m + torch.maximum(ai, aj)])
        keys = torch.cat([keys.long(), arc_keys])
        blocks = _blocks_view(h, m, p)
        blocks.index_put_((keys // m, keys % m), torch.cat([pair, arc_vals]).view(-1, p, p), accumulate=True)
    return finish_normal_matrix(h, g.node_valid, levenberg, p)


def _direct_solve(h: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Cholesky solve of ``h δ = rhs`` (``h (..., n, n)``, ``rhs (..., M,
    P)``) with no host wait: ``cholesky_ex`` leaves its status on the
    device. A batch is solved system by system: PyTorch sends a batch of
    large matrices to MAGMA, whose batched factorization and triangular
    solves wait on the host and, for 8 systems of 6,336, took over three
    times as long as 8 single cuSOLVER solves on an H100."""
    if h.dim() > 2:
        return torch.stack([_direct_solve(hb, rb) for hb, rb in zip(h, rhs)])
    chol, _ = torch.linalg.cholesky_ex(h)
    return torch.cholesky_solve(rhs.reshape(-1, 1), chol).reshape(rhs.shape)


def _block_jacobi(t: _Terms, levenberg: float):
    """Rigid 3-D: the exact per-node (6, 6) diagonal block of JᵀJ, inverted."""
    g = t.graph
    n, k = g.anchors.shape
    m = g.num_nodes
    b_anchor = _row_blocks(t.y, False)  # (N, K, 3, 6)
    blocks = t.w_pp[:, None, None, None] * torch.einsum("nkdi,nkdj->nkij", b_anchor, b_anchor)
    if t.normals is not None:
        bn = torch.einsum("nd,nkdi->nki", t.normals, b_anchor)
        blocks = blocks + t.w_pl[:, None, None, None] * torch.einsum("nki,nkj->nkij", bn, bn)
    blocks = blocks * (g.anchor_weights**2)[..., None, None]
    node_blocks = g.segment_over_anchors(blocks.reshape(n, k, 36)).reshape(m, 6, 6)
    sa = (t.stiffness * t.w_arc)[:, None, None]
    b_i = _row_blocks(t.y_jl, False)
    b_j = -_row_blocks(t.y_ll, False)
    node_blocks = node_blocks + g.segment_over_arc_i(sa * torch.einsum("adi,adj->aij", b_i, b_i))
    node_blocks = node_blocks + g.segment_over_arc_j(
        (sa * torch.einsum("adi,adj->aij", b_j, b_j)).reshape(-1, 36)
    ).reshape(m, 6, 6)
    node_blocks = node_blocks + (levenberg + 1e-8) * torch.eye(6, dtype=t.y.dtype, device=t.y.device)
    prec = torch.linalg.inv_ex(node_blocks)[0]
    return lambda r: torch.einsum("mij,mj->mi", prec, r)


def _lumped_diagonal(t: _Terms, levenberg: float):
    """The lumped-diagonal estimate (conditioning only, never correctness)."""
    g = t.graph
    m, n_lin, d = g.num_nodes, t.n_lin, t.d
    wa = g.anchor_weights
    ww = (t.w_pp + t.w_pl)[:, None] * wa**2  # (N, K)
    acc_w = g.segment_over_anchors(ww * torch.sum(t.y * t.y, dim=-1))
    acc_t = g.segment_over_anchors(ww)
    sa = t.stiffness * t.w_arc
    arc_w = g.segment_over_arc_i(sa * torch.sum(t.y_jl * t.y_jl, -1)) + g.segment_over_arc_j(
        sa * torch.sum(t.y_ll * t.y_ll, -1)
    )
    arc_t = g.segment_over_arc_i(sa) + g.segment_over_arc_j(sa)
    diag = torch.cat(
        [(acc_w + arc_w)[:, None].expand(m, n_lin), (acc_t + arc_t)[:, None].expand(m, d)], dim=1
    ) + levenberg
    precond_vec = 1.0 / torch.clamp(diag, min=_EPS)
    return lambda r: precond_vec * r


def _cg_solve(t: _Terms, rhs, levenberg: float, max_iterations: int, tol: float):
    """Preconditioned CG on (JᵀJ + λI) δ = rhs with Eigen's relative
    tolerance (``warp_field_estimation.hpp:188-192``). Returns ``(δ,
    iterations (int32, on the device))``."""
    precond = _block_jacobi(t, levenberg) if (not t.affine and t.d == 3) else _lumped_diagonal(t, levenberg)

    def matvec(delta):
        return t.jt_apply(*t.j_apply(delta)) + levenberg * delta

    thresh = tol * tol * torch.sum(rhs * rhs)
    x = torch.zeros_like(rhs)
    r = rhs
    p = z = precond(r)
    rz = torch.sum(r * z)
    k = torch.zeros((), dtype=torch.int32, device=rhs.device)

    def going(k, r):
        return (k < max_iterations) & (torch.sum(r * r) > thresh)

    while bool(going(k, r)):
        for _ in range(_CG_CHUNK):
            active = going(k, r)
            ap = matvec(p)
            alpha = rz / torch.clamp(torch.sum(p * ap), min=_EPS)
            r1 = r - alpha * ap
            z1 = precond(r1)
            rz1 = torch.sum(r1 * z1)
            beta = rz1 / torch.clamp(rz, min=_EPS)
            x = torch.where(active, x + alpha * p, x)
            p = torch.where(active, z1 + beta * p, p)
            r = torch.where(active, r1, r)
            rz = torch.where(active, rz1, rz)
            k = k + active.to(torch.int32)
    return x, k


def _apply_increment(node_tf: Transform, delta, node_valid, affine: bool):
    """ΔT(δ) ∘ T per node (rotation re-projection keeps rigid fields rigid;
    affine fields compose exactly) and the largest increment norm over the
    live nodes."""
    m, d = node_tf.translation.shape
    n_lin = d * d if affine else (d if d == 3 else 1)
    dw, dt = delta[:, :n_lin], delta[:, n_lin:]
    if affine:
        lin_inc = torch.eye(d, dtype=delta.dtype, device=delta.device) + dw.reshape(m, d, d)
    elif d == 3:
        lin_inc = axis_angle_to_rotation(dw)
    else:
        c, s = torch.cos(dw[:, 0]), torch.sin(dw[:, 0])
        lin_inc = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
    new_tf = compose(Transform(lin_inc, dt), node_tf)
    if not affine:
        new_tf = Transform(project_to_rotation(new_tf.linear), new_tf.translation)
    upd = torch.amax(torch.where(node_valid, torch.linalg.vector_norm(delta, dim=1), 0.0))
    return new_tf, upd


def use_direct_solver(solver: str, m: int, n: int, k: int, d: int, affine: bool) -> bool:
    """JAX's choice (``solver="auto"``): direct when the dense system and
    the pair blocks are small enough."""
    n_par = (d * d if affine else (d if d == 3 else 1)) + d
    if solver == "auto":
        return m * n_par <= 8192 and n * k * k * n_par * n_par * 4 <= 1_500_000_000
    if solver in ("direct", "cg"):
        return solver == "direct"
    raise ValueError(f"unknown solver {solver!r}")


def _gn_step(
    graph, node_tf, src_points, dst_points, dst_normals, w_pp, w_pl, *, stiffness, huber_delta,
    levenberg, affine, direct, max_cg_iterations, cg_tol,
):
    """One GN iteration: ``(new transforms, max update, CG iterations)``.
    The direct route never waits on the host."""
    t = _linearize(
        graph, node_tf, src_points, dst_points, dst_normals, w_pp, w_pl, stiffness=stiffness,
        huber_delta=huber_delta, affine=affine,
    )
    rhs = t.rhs()
    if direct:
        delta = _direct_solve(_normal_matrix(t, levenberg), rhs)
        cg_k = torch.zeros((), dtype=torch.int32, device=rhs.device)
    else:
        delta, cg_k = _cg_solve(t, rhs, levenberg, max_cg_iterations, cg_tol)
    new_tf, upd = _apply_increment(node_tf, delta, graph.node_valid, affine)
    return new_tf, upd, cg_k


def estimate_warp_field(
    graph: DeformationGraph,
    src_points,
    dst_points,
    dst_normals,
    corr_weights,
    *,
    init: Optional[Transform] = None,
    point_weight: float = 0.0,
    plane_weight: float = 1.0,
    stiffness: float = 200.0,
    huber_delta: float = 1e-2,
    max_gn_iterations: int = 10,
    gn_tol: float = 2.5e-3,
    max_cg_iterations: int = 500,
    cg_tol: float = 1e-5,
    levenberg: float = 1e-6,
    node_type: str = "rigid",
    solver: str = "auto",
    device="cuda",
) -> Tuple[Transform, torch.Tensor, torch.Tensor]:
    """Per-node transforms minimizing the combined metric plus
    stiffness-weighted sqrt-Huber arc regularization (the sparse solvers at
    ``warp_field_estimation.hpp:1387-1847``; defaults follow
    ``non_rigid_icp.cpp:66-82``).

    ``node_type='rigid'``: small-angle increments ``[δω; δt]`` with SO(D)
    re-projection (D ∈ {2, 3}); ``'affine'``: full linear increments
    ``[vec(δA); δt]`` in any dimension. ``solver``: ``'cg'`` (matrix-free
    preconditioned CG, block-Jacobi for rigid 3-D, else the lumped
    diagonal), ``'direct'`` (dense normal matrix, Cholesky) or ``'auto'``
    (direct when node capacity × parameters ≤ 8192 and the pair blocks fit
    in 1.5 GB).

    Returns ``(node_transforms, converged, total_cg_iterations)`` (0 CG
    iterations under the direct solver), the last two as device tensors.
    """
    dev = resolve_device(device)
    graph = graph.to(dev)
    src_points, dst_points = _on(src_points, dev), _on(dst_points, dev)
    dst_normals, corr_weights = _on(dst_normals, dev), _on(corr_weights, dev)
    m = graph.num_nodes
    n, d = src_points.shape
    node_tf = (
        Transform(_on(init.linear, dev), _on(init.translation, dev))
        if init is not None
        else identity_warp(m, d, device=dev)
    )
    affine = node_type == "affine"
    direct = use_direct_solver(solver, m, n, graph.anchors.shape[1], d, affine)
    w_pp = corr_weights * point_weight
    w_pl = corr_weights * plane_weight
    upd = torch.full((), float("inf"), dtype=src_points.dtype, device=dev)
    cg_total = torch.zeros((), dtype=torch.int32, device=dev)
    for it in range(max_gn_iterations):
        if it > 0 and not bool(upd >= gn_tol):
            break
        node_tf, upd, cg_k = _gn_step(
            graph, node_tf, src_points, dst_points, dst_normals, w_pp, w_pl,
            stiffness=stiffness, huber_delta=huber_delta, levenberg=levenberg, affine=affine,
            direct=direct, max_cg_iterations=max_cg_iterations, cg_tol=cg_tol,
        )
        cg_total = cg_total + cg_k
    return node_tf, upd < gn_tol, cg_total


# ---------------------------------------------------------------------------
# Non-rigid ICP outer loops (sparse EDG + dense warp fields).
# ---------------------------------------------------------------------------


def node_motion(new_tf: Transform, old_tf: Transform, node_valid) -> torch.Tensor:
    """The outer loops' convergence norm: the largest per-node motion
    between two iterations (``icp_warp_field_combined_metric_sparse.hpp``)."""
    dl = new_tf.linear - old_tf.linear
    dt = new_tf.translation - old_tf.translation
    motion = torch.sqrt(torch.sum(dl**2, dim=(-2, -1)) + torch.sum(dt**2, dim=-1))
    return torch.amax(torch.where(node_valid, motion, 0.0), dim=-1)


def _outer_loop(step, node_tf, max_iterations, convergence_tol, dev):
    """JAX's ``while (it < max) & any(upd >= tol)`` with one host read an
    iteration: ``(transforms, iterations, converged)``; ``step(node_tf)``
    returns the new transforms and their node motion (0-d, or one a
    stream)."""
    it, upd = 0, None
    while it < max_iterations and (it == 0 or bool(torch.any(upd >= convergence_tol))):
        node_tf, upd = step(node_tf)
        it += 1
    if upd is None:
        upd = torch.full((), float("inf"), device=dev)
    return node_tf, torch.tensor(it, dtype=torch.int32, device=dev), upd < convergence_tol


def icp_warp_field(
    graph: DeformationGraph,
    src_points,
    dst_points,
    *,
    dst_normals=None,
    src_valid=None,
    dst_valid=None,
    max_corr_dist_sq: float = 0.0025,
    point_weight: float = 0.1,
    plane_weight: float = 1.0,
    stiffness: float = 200.0,
    huber_delta: float = 1e-2,
    max_iterations: int = 15,
    convergence_tol: float = 2.5e-3,
    max_gn_iterations: int = 1,
    max_cg_iterations: int = 500,
    node_type: str = "rigid",
    solver: str = "auto",
    device="cuda",
) -> Tuple[Transform, torch.Tensor, torch.Tensor]:
    """Sparse (EDG) non-rigid ICP (``CombinedMetricSparseWarpFieldICP``,
    ``icp_warp_field_combined_metric_sparse.hpp:202-240``; example defaults
    ``non_rigid_icp.cpp:66-84``). Each outer iteration: warp src by the
    blended field → NN correspondences (on the card through the prune plan
    built once here when the problem is large) → one GN step on the node
    transforms. Returns ``(node_transforms, iterations, converged)``."""
    from ..correspondence.search import find_nn_correspondences
    from ..neighbors.fused_nn import maybe_make_nn1_prune_plan

    dev = resolve_device(device)
    graph = graph.to(dev)
    src_points, dst_points = _on(src_points, dev), _on(dst_points, dev)
    dst_normals = _on(dst_normals, dev)
    src_valid, dst_valid = _on(src_valid, dev, torch.bool), _on(dst_valid, dev, torch.bool)
    n, d = src_points.shape
    if src_valid is None:
        src_valid = torch.ones(n, dtype=torch.bool, device=dev)
    prune_plan = maybe_make_nn1_prune_plan(
        dst_points, max_corr_dist_sq, src_points, key_valid=dst_valid, query_valid=src_valid
    )
    gn = dict(
        point_weight=point_weight, plane_weight=plane_weight, stiffness=stiffness,
        huber_delta=huber_delta, max_gn_iterations=max_gn_iterations, gn_tol=0.0,
        max_cg_iterations=max_cg_iterations, node_type=node_type, solver=solver, device=dev,
    )

    def step(node_tf):
        warped = _warp_points(graph, node_tf, src_points)
        corr = find_nn_correspondences(
            warped, dst_points, query_valid=src_valid, dst_valid=dst_valid,
            max_distance=max_corr_dist_sq, prune_plan=prune_plan,
        )
        safe = torch.where(corr.mask, corr.dst_idx, 0).long()
        ngt = dst_normals[safe] if dst_normals is not None else None
        new_tf, _, _ = estimate_warp_field(
            graph, src_points, dst_points[safe], ngt, corr.mask.to(src_points.dtype),
            init=node_tf, **gn,
        )
        return new_tf, node_motion(new_tf, node_tf, graph.node_valid)

    return _outer_loop(step, identity_warp(graph.num_nodes, d, device=dev), max_iterations,
                       convergence_tol, dev)


def build_dense_graph(src_points, *, src_valid=None, k_arcs: int = 8, device="cuda") -> DeformationGraph:
    """Dense warp field as a degenerate EDG: every point is its own node with
    weight 1 (maps the dense solvers, ``warp_field_estimation.hpp:92-995``);
    regularization arcs from the point k-NN graph."""
    dev = resolve_device(device)
    src_points = _on(src_points, dev)
    n = src_points.shape[0]
    src_valid = _on(src_valid, dev, torch.bool)
    if src_valid is None:
        src_valid = torch.ones(n, dtype=torch.bool, device=dev)
    arcs = knn_search(
        src_points, src_points, k_arcs, query_valid=src_valid, key_valid=src_valid,
        exclude_self=True,
    )
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    return _with_sort_caches(
        _bare_graph(
            src_points, src_valid, ids[:, None], src_valid.to(src_points.dtype)[:, None],
            ids.repeat_interleave(k_arcs), arcs.indices.reshape(-1), arcs.mask.reshape(-1),
        )
    )


def icp_warp_field_projective(
    graph: DeformationGraph,
    src_points,
    dst_points,
    intrinsics,
    *,
    height: int,
    width: int,
    index_map=None,
    dst_normals=None,
    src_valid=None,
    dst_valid=None,
    max_corr_dist_sq: float = 0.0025,
    point_weight: float = 0.1,
    plane_weight: float = 1.0,
    stiffness: float = 200.0,
    huber_delta: float = 1e-2,
    max_iterations: int = 15,
    convergence_tol: float = 2.5e-3,
    max_gn_iterations: int = 1,
    max_cg_iterations: int = 500,
    node_type: str = "rigid",
    solver: str = "auto",
    device="cuda",
) -> Tuple[Transform, torch.Tensor, torch.Tensor]:
    """Non-rigid ICP with projective correspondences
    (``icp_common_instances.hpp:246-335``). Both clouds live in the dst
    camera frame; the dst index map is rendered once and packed
    (:func:`..correspondence.projective.pack_projective_target`), so an
    outer iteration is one warp, one projection and one row gather
    (``coalesced_gather``)."""
    from ..core.rgbd import points_to_index_map
    from ..correspondence.projective import (
        find_projective_correspondences_packed,
        pack_projective_target,
    )

    dev = resolve_device(device)
    graph = graph.to(dev)
    src_points, dst_points = _on(src_points, dev), _on(dst_points, dev)
    dst_normals = _on(dst_normals, dev)
    src_valid, dst_valid = _on(src_valid, dev, torch.bool), _on(dst_valid, dev, torch.bool)
    n, d = src_points.shape
    if src_valid is None:
        src_valid = torch.ones(n, dtype=torch.bool, device=dev)
    if index_map is None:
        index_map = points_to_index_map(dst_points, intrinsics, height, width, valid=dst_valid)
    packed = pack_projective_target(dst_points, dst_normals, _on(index_map, dev), dst_valid=dst_valid)
    gn = dict(
        point_weight=point_weight, plane_weight=plane_weight, stiffness=stiffness,
        huber_delta=huber_delta, max_gn_iterations=max_gn_iterations, gn_tol=0.0,
        max_cg_iterations=max_cg_iterations, node_type=node_type, solver=solver, device=dev,
    )

    def step(node_tf):
        warped = _warp_points(graph, node_tf, src_points)
        _, dgt, ngt, w = find_projective_correspondences_packed(
            warped, packed, intrinsics, height, width, src_valid=src_valid,
            max_distance=max_corr_dist_sq,
        )
        new_tf, _, _ = estimate_warp_field(
            graph, src_points, dgt, ngt if dst_normals is not None else None, w, init=node_tf, **gn
        )
        return new_tf, node_motion(new_tf, node_tf, graph.node_valid)

    return _outer_loop(step, identity_warp(graph.num_nodes, d, device=dev), max_iterations,
                       convergence_tol, dev)
