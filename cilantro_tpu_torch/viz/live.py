"""During-run map visualization: a periodic-snapshot hook for the fusion
drivers (port of ``cilantro_tpu/viz/live.py``).

The reference renders the live fusion map inside its Pangolin window every
frame (``examples/fusion.cpp:241-250``, ``src/visualization/visualizer.cpp``).
A headless machine has no window, so "live" is a *snapshot stream*: pass a
:class:`LiveMapViewer` as the ``on_frame`` callback of
:func:`cilantro_tpu_torch.slam.run_fusion_sequence` and it rewrites one
self-contained HTML viewer (auto-refreshing) every N frames. Open the file
in any browser while the run progresses; each refresh shows the current
map and camera frustum.

Cost (why this is opt-in): each snapshot waits for the card, selects the
live map rows there, copies the subsample to the host and writes the page,
outside the pipeline's own work (the driver does not count a hook's time).
``subsample`` bounds the copy; ``every`` bounds the frequency.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .interactive import _host


class LiveMapViewer:
    """``on_frame`` callback: periodic standalone-HTML snapshots of the
    fusion map + current camera."""

    def __init__(
        self,
        path: str,
        *,
        every: int = 10,
        subsample: int = 200_000,
        refresh_seconds: float = 2.0,
        point_size: float = 1.5,
    ):
        self.path = path
        self.every = max(int(every), 1)
        self.subsample = int(subsample)
        self.refresh_seconds = float(refresh_seconds)
        self.point_size = float(point_size)
        self.snapshots = 0

    def __call__(self, frame_idx: int, fmap, pose) -> None:
        if frame_idx % self.every != 0:
            return
        from ..viz.interactive import (
            CameraFrustumRenderable,
            PointCloudRenderable,
            RenderingProperties,
            Visualizer,
        )

        pts = fmap.points[fmap.valid]  # on the map's device
        if len(pts) > self.subsample:
            step = max(len(pts) // self.subsample, 1)
            pts = pts[::step]
        pts = _host(pts)
        viz = Visualizer(window_name=f"fusion live (frame {frame_idx})")
        cloud = PointCloudRenderable(
            pts,
            rp=RenderingProperties(point_size=self.point_size),
        )
        if len(pts):
            cloud.set_point_values(pts[:, 2])  # depth-colored
        viz.add_object("map", cloud)
        mat = _host(pose.matrix()) if hasattr(pose, "matrix") else _host(pose)
        viz.add_object(
            "camera",
            CameraFrustumRenderable(
                640, 480,
                np.array(
                    [[525.0, 0, 319.5], [0, 525.0, 239.5], [0, 0, 1]],
                    np.float32,
                ),
                pose=mat, scale=0.15,
            ),
        )
        tmp = self.path + ".tmp"
        viz.export_html(tmp)
        with open(tmp) as f:
            html = f.read()
        # Auto-refresh so an open browser follows the run.
        html = html.replace(
            "<head>",
            f'<head><meta http-equiv="refresh" '
            f'content="{self.refresh_seconds:g}">',
            1,
        )
        with open(tmp, "w") as f:
            f.write(html)
        os.replace(tmp, self.path)
        self.snapshots += 1
