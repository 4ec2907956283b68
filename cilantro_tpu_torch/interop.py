"""Port state from the JAX package's state, passed as numpy arrays.

Each function takes the leaves of a JAX object as numpy arrays
(``np.asarray(smap.rows)``, ``np.asarray(smap.pose.linear)``, ...), never
the JAX object itself, so that this package needs no JAX. A test can then
start a port function from the exact state the JAX package reached.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .core.containers import PointCloud
from .core.pca import PCA
from .core.rgbd import CameraIntrinsics
from .core.transforms import Transform
from .model_estimation.ransac import Hyperplane
from .neighbors.api import Neighborhoods
from .registration.warp_field import DeformationGraph, _with_segment_lengths
from .slam.fusion import FusionMap
from .slam.keyframes import Keyframe, KeyframeGraph
from .slam.splat_fusion import SplatMap
from .spatial.convex import ConvexPolytope


def transform_from_numpy(linear, translation, device="cuda") -> Transform:
    dev = resolve_device(device)
    return Transform(
        torch.as_tensor(np.asarray(linear, np.float32), device=dev),
        torch.as_tensor(np.asarray(translation, np.float32), device=dev),
    )


def splat_map_from_numpy(rows, linear, translation, device="cuda") -> SplatMap:
    dev = resolve_device(device)
    return SplatMap(
        rows=torch.as_tensor(np.asarray(rows, np.float32), device=dev),
        pose=transform_from_numpy(linear, translation, device=dev),
    )


def fusion_map_from_numpy(data, device="cuda") -> FusionMap:
    """A port pool from a JAX ``FusionMap``'s ``data`` ((C, 16) or (C, 8))."""
    return FusionMap(data=torch.as_tensor(np.array(data, np.float32), device=resolve_device(device)))


def intrinsics_from_numpy(fx, fy, cx, cy) -> CameraIntrinsics:
    return CameraIntrinsics.make(
        *(float(np.asarray(v)) for v in (fx, fy, cx, cy))
    )


def _leaf(a, dtype, dev):
    """A tensor copy of one leaf on ``dev`` (None stays None)."""
    return None if a is None else torch.as_tensor(np.array(a, dtype), device=dev)


def point_cloud_from_numpy(
    points, normals=None, colors=None, valid=None, device="cuda"
) -> PointCloud:
    """A port cloud from the leaves of a JAX ``PointCloud`` (None where the
    JAX cloud has None)."""
    dev = resolve_device(device)
    return PointCloud(
        points=_leaf(points, np.float32, dev),
        normals=_leaf(normals, np.float32, dev),
        colors=_leaf(colors, np.float32, dev),
        valid=_leaf(valid, bool, dev),
    )


def neighborhoods_from_numpy(
    indices, distances, mask, overflowed=None, device="cuda"
) -> Neighborhoods:
    """Port ``Neighborhoods`` from the leaves of a JAX ``Neighborhoods``."""
    dev = resolve_device(device)
    return Neighborhoods(
        indices=_leaf(indices, np.int32, dev),
        distances=_leaf(distances, np.float32, dev),
        mask=_leaf(mask, bool, dev),
        overflowed=_leaf(overflowed, bool, dev),
    )


def icp_result_to_numpy(result) -> dict:
    """A port ``ICPResult`` as numpy: ``linear``, ``translation``,
    ``iterations``, ``delta_norm``, ``converged``, ``num_correspondences``
    (the JAX result's leaves under the same names)."""
    tf = result.transform
    return {
        "linear": tf.linear.detach().cpu().numpy(),
        "translation": tf.translation.detach().cpu().numpy(),
        "iterations": int(result.iterations),
        "delta_norm": float(result.delta_norm),
        "converged": bool(result.converged),
        "num_correspondences": int(result.num_correspondences),
    }


def deformation_graph_from_numpy(device="cuda", **leaves) -> DeformationGraph:
    """A port ``DeformationGraph`` from the leaves of a JAX one, caches
    included: each field by name (``np.asarray(g.anchors)``, ...; None where
    JAX's is None) and ``caches_sorted`` as a bool. The port's segment
    lengths are counted from the caches, so a JAX-built graph can be fed to
    the port's solvers."""
    dev = resolve_device(device)
    caches_sorted = bool(leaves.pop("caches_sorted", True))
    bools = ("node_valid", "arc_mask", "ps_swap")
    floats = ("node_positions", "anchor_weights", "ps_w2")
    fields = {
        name: _leaf(a, bool if name in bools else np.float32 if name in floats else np.int32, dev)
        for name, a in leaves.items()
    }
    return _with_segment_lengths(DeformationGraph(caches_sorted=caches_sorted, **fields))


def keyframe_graph_from_numpy(keyframes, edge_i, edge_j, measurements, edge_weights) -> KeyframeGraph:
    """A port ``KeyframeGraph`` from a JAX one's fields: ``keyframes`` (each
    with ``index``, ``pose``, ``points``, ``normals``, all host numpy in
    the JAX package too) and the edge lists. Every array is copied, so the
    two graphs grow apart from here on."""

    def copy(a):
        return None if a is None else np.array(a)

    return KeyframeGraph(
        keyframes=[Keyframe(int(kf.index), copy(kf.pose), copy(kf.points), copy(kf.normals))
                   for kf in keyframes],
        edge_i=[int(i) for i in edge_i],
        edge_j=[int(j) for j in edge_j],
        measurements=[copy(z) for z in measurements],
        edge_weights=[float(w) for w in edge_weights],
    )


def ba_problem_from_numpy(linear, translation, landmarks, cam_idx, lmk_idx, observations,
                          device="cuda"):
    """The arguments of the port's ``bundle_adjust`` from numpy: ``(poses,
    landmarks, cam_idx, lmk_idx, observations)`` on ``device``, e.g. the
    problem the JAX package built, for ``bundle_adjust(*problem, ...)``."""
    dev = resolve_device(device)
    return (
        transform_from_numpy(linear, translation, device=dev),
        _leaf(landmarks, np.float32, dev),
        _leaf(cam_idx, np.int64, dev),
        _leaf(lmk_idx, np.int64, dev),
        _leaf(observations, np.float32, dev),
    )


def hyperplane_from_numpy(normal, offset, device="cuda") -> Hyperplane:
    """A port ``Hyperplane`` from a JAX one's ``normal`` and ``offset``."""
    dev = resolve_device(device)
    return Hyperplane(normal=_leaf(normal, np.float32, dev), offset=_leaf(offset, np.float32, dev))


def pca_from_numpy(mean, eigenvalues, eigenvectors, device="cuda") -> PCA:
    """A port ``PCA`` from a JAX one's ``mean``, ``eigenvalues`` and
    ``eigenvectors``."""
    dev = resolve_device(device)
    return PCA(mean=_leaf(mean, np.float32, dev), eigenvalues=_leaf(eigenvalues, np.float32, dev),
               eigenvectors=_leaf(eigenvectors, np.float32, dev))


def convex_polytope_from_numpy(**fields) -> ConvexPolytope:
    """A port ``ConvexPolytope`` from a JAX one's fields by name
    (``dataclasses.asdict`` of it): both packages keep the polytope on the
    host as numpy, so every array is copied and nothing moves to a device."""

    def copy(a):
        if a is None or isinstance(a, (bool, np.bool_)):
            return a
        if isinstance(a, (list, tuple)):
            return [np.array(x) for x in a]
        return np.array(a)

    return ConvexPolytope(**{name: copy(value) for name, value in fields.items()})


def shard_from_numpy(mesh, axis: str, array) -> torch.Tensor:
    """This rank's shard of a JAX array sharded over ``axis`` of a
    ``(points, map)`` mesh, from the global numpy array ``jax.device_get``
    gives of it (its leading dimension split in mesh order), on the mesh's
    device: so both packages start a sharded path from the same state."""
    from .parallel.sharded import shard_rows

    return shard_rows(np.array(array), mesh, axis)


def sharded_map_from_numpy(mesh, data, axis: str = "map") -> torch.Tensor:
    """This rank's ``(C/D, 16)`` shard of a JAX map-sharded pool, from its
    global ``(C, 16)`` numpy array (``init_sharded_map``'s layout)."""
    return shard_from_numpy(mesh, axis, np.asarray(data, np.float32))
