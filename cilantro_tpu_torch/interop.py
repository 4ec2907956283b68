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
