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
from .core.rgbd import CameraIntrinsics
from .core.transforms import Transform
from .neighbors.api import Neighborhoods
from .registration.warp_field import DeformationGraph, _with_segment_lengths
from .slam.fusion import FusionMap
from .slam.splat_fusion import SplatMap


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
