"""Pool fusion: one stream a call through ``run_fusion_sequence_scanned``,
or B streams a call, one frame of each a step, through
``run_batched_fusion_sequences``; the traffic's ``streams`` decides."""

from __future__ import annotations

from typing import List

import numpy as np

from ..reference import pool as ref_pool
from ..reference.geometry import Intrinsics
from . import Output


class Pipeline:
    def __init__(self, config: dict, traffic: dict, device):
        from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
        from cilantro_tpu_torch.slam.batched_fusion import run_batched_fusion_sequences
        from cilantro_tpu_torch.slam.driver import run_fusion_sequence_scanned
        from cilantro_tpu_torch.slam.fusion import FusionConfig

        s = config["sensor"]
        self.settings = dict(config["settings"])
        self.cfg = FusionConfig(**self.settings)
        self.capacity = int(config["map_capacity"])
        self.streams = int(traffic["streams"])
        self.intrinsics = CameraIntrinsics.make(s["fx"], s["fy"], s["cx"], s["cy"])
        self.ref_intrinsics = Intrinsics.make(s["fx"], s["fy"], s["cx"], s["cy"])
        self.single = run_fusion_sequence_scanned
        self.batched = run_batched_fusion_sequences
        self.device = device

    def inputs(self, depths: np.ndarray) -> List[np.ndarray]:
        """Calls of ``streams`` clips each, ``(B, F, H, W)``."""
        b = self.streams
        if len(depths) % b:
            raise ValueError(f"{len(depths)} clips do not fill calls of {b} streams")
        return [depths[i:i + b] for i in range(0, len(depths), b)]

    def call(self, stack: np.ndarray) -> Output:
        frames = stack.shape[0] * stack.shape[1]
        if self.streams == 1:
            fmap, m = self.single(stack[0], self.intrinsics, map_capacity=self.capacity,
                                  cfg=self.cfg, device=self.device)
            return Output(poses=np.stack(m.poses)[None], maps=[fmap.data], frames=frames)
        data, m = self.batched(stack, self.intrinsics, map_capacity=self.capacity, cfg=self.cfg,
                               device=self.device)
        return Output(poses=np.asarray(m.poses), maps=list(data), frames=frames)

    @staticmethod
    def cloud(data):
        return ref_pool.map_cloud(data)

    def reference(self, stack: np.ndarray, device) -> Output:
        poses, data, _ = ref_pool.run(stack, self.ref_intrinsics, self.settings, self.capacity,
                                      device)
        return Output(poses=poses, maps=list(data), frames=stack.shape[0] * stack.shape[1])
