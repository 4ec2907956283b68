"""Checkpoint / resume for the fusion pipeline (port of
``cilantro_tpu/slam/checkpoint.py``).

One ``.npz`` holds the whole carry of :func:`.driver.run_fusion_sequence`:
the packed pool, the trajectory, the ICP iteration counts, the cached index
map, and optionally a keyframe graph. The keys and types are the JAX
package's, so either package resumes from a checkpoint the other wrote.
Resuming reproduces the uninterrupted run's trajectory tail bit for bit on
one device (the index map is part of the carry, so even the first render
after the resume is the same).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .. import resolve_device
from .fusion import FusionMap
from .keyframes import Keyframe, KeyframeGraph


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class FusionCheckpoint:
    map_data: np.ndarray  # (C, 16) packed pool
    poses: List[np.ndarray]  # (4, 4) camera-to-world per processed frame
    next_frame: int  # index of the first unprocessed frame
    index_map: Optional[np.ndarray]  # (H, W) cached render, or None
    graph: Optional[KeyframeGraph]
    icp_iterations: Optional[np.ndarray] = None  # per processed frame

    def fusion_map(self, device="cuda") -> FusionMap:
        return FusionMap(data=torch.as_tensor(self.map_data, device=resolve_device(device)))


def save_checkpoint(
    path: str,
    fmap: FusionMap,
    poses: List[np.ndarray],
    next_frame: int,
    *,
    index_map=None,
    graph: Optional[KeyframeGraph] = None,
    icp_iterations=None,
) -> None:
    """Write the fusion carry (and optionally a keyframe graph) to ``path``;
    tensors are copied to the host."""
    arrays = {
        "map_data": _host(fmap.data),
        "poses": np.stack([_host(p) for p in poses]),
        "next_frame": np.asarray(next_frame, np.int64),
    }
    if icp_iterations is not None:
        arrays["icp_iterations"] = np.asarray(icp_iterations, np.int32)
    if index_map is not None:
        arrays["index_map"] = _host(index_map)
    if graph is not None:
        arrays["n_keyframes"] = np.asarray(len(graph.keyframes), np.int64)
        for i, kf in enumerate(graph.keyframes):
            arrays[f"kf{i}_index"] = np.asarray(kf.index, np.int64)
            arrays[f"kf{i}_pose"] = np.asarray(kf.pose)
            arrays[f"kf{i}_points"] = np.asarray(kf.points)
            if kf.normals is not None:
                arrays[f"kf{i}_normals"] = np.asarray(kf.normals)
        arrays["edge_i"] = np.asarray(graph.edge_i, np.int64)
        arrays["edge_j"] = np.asarray(graph.edge_j, np.int64)
        if graph.measurements:
            arrays["edge_z"] = np.stack([np.asarray(z) for z in graph.measurements])
        arrays["edge_w"] = np.asarray(graph.edge_weights, np.float32)
    np.savez_compressed(path, **arrays)


def load_checkpoint(path: str) -> FusionCheckpoint:
    with np.load(path) as z:
        graph = None
        if "n_keyframes" in z:
            graph = KeyframeGraph.empty()
            for i in range(int(z["n_keyframes"])):
                graph.add_keyframe(
                    Keyframe(
                        index=int(z[f"kf{i}_index"]),
                        pose=z[f"kf{i}_pose"],
                        points=z[f"kf{i}_points"],
                        normals=z[f"kf{i}_normals"] if f"kf{i}_normals" in z else None,
                    )
                )
            edge_z = z["edge_z"] if "edge_z" in z else np.zeros((0, 4, 4))
            graph.edge_i = [int(v) for v in z["edge_i"]]
            graph.edge_j = [int(v) for v in z["edge_j"]]
            graph.measurements = [m for m in edge_z]
            graph.edge_weights = [float(v) for v in z["edge_w"]]
        return FusionCheckpoint(
            map_data=z["map_data"],
            poses=[p for p in z["poses"]],
            next_frame=int(z["next_frame"]),
            index_map=z["index_map"] if "index_map" in z else None,
            graph=graph,
            icp_iterations=z["icp_iterations"] if "icp_iterations" in z else None,
        )
