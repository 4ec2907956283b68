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


def intrinsics_from_numpy(fx, fy, cx, cy) -> CameraIntrinsics:
    return CameraIntrinsics.make(
        *(float(np.asarray(v)) for v in (fx, fy, cx, cy))
    )


def point_cloud_from_numpy(
    points, normals=None, colors=None, valid=None, device="cuda"
) -> PointCloud:
    """A port cloud from the leaves of a JAX ``PointCloud`` (None where the
    JAX cloud has None)."""
    dev = resolve_device(device)

    def leaf(a, dtype):
        return None if a is None else torch.as_tensor(np.asarray(a, dtype), device=dev)

    return PointCloud(
        points=leaf(points, np.float32),
        normals=leaf(normals, np.float32),
        colors=leaf(colors, np.float32),
        valid=leaf(valid, bool),
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
