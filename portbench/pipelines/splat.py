"""Surfel-splat fusion through ``run_splat_sequence_scanned``: one clip a
call, one stream."""

from __future__ import annotations

from typing import List

import numpy as np

from ..reference import splat as ref_splat
from ..reference.geometry import Intrinsics
from . import Output


class Pipeline:
    def __init__(self, config: dict, traffic: dict, device):
        from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
        from cilantro_tpu_torch.slam.splat_fusion import SplatConfig, run_splat_sequence_scanned

        if traffic["streams"] != 1:
            raise ValueError("splat fusion serves one stream a call")
        s = config["sensor"]
        self.settings = dict(config["settings"])
        self.cfg = SplatConfig(**self.settings)
        self.intrinsics = CameraIntrinsics.make(s["fx"], s["fy"], s["cx"], s["cy"])
        self.ref_intrinsics = Intrinsics.make(s["fx"], s["fy"], s["cx"], s["cy"])
        self.entry = run_splat_sequence_scanned
        self.device = device

    def inputs(self, depths: np.ndarray) -> List[np.ndarray]:
        """One call a clip, ``(1, F, H, W)``."""
        return [depths[i:i + 1] for i in range(len(depths))]

    def call(self, clip: np.ndarray) -> Output:
        smap, poses, _, _ = self.entry(clip[0], self.intrinsics, cfg=self.cfg, device=self.device)
        return Output(poses=np.stack(poses)[None], maps=[smap.rows], frames=clip.shape[1])

    @staticmethod
    def cloud(rows):
        return ref_splat.map_cloud(rows)

    def reference(self, clip: np.ndarray, device) -> Output:
        poses, rows, _ = ref_splat.run(clip[0], self.ref_intrinsics, self.settings, device)
        return Output(poses=poses[None], maps=[rows], frames=clip.shape[1])
