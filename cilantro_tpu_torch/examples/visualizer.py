"""Interactive Visualizer demo (port of ``examples/visualizer.py``) — the
reference's ``examples/visualizer.cpp`` recipe, headless: two scenes
exported as standalone interactive HTML artifacts (WebGL trackball viewer,
zero dependencies).

Scene 1: the cloud colormapped by distance-to-origin + a coordinate frame +
anchored text.  Scene 2: two opacity-blended copies with correspondence
lines.  Open the written ``.html`` files in any browser; keys mirror the
reference handler (r/+/-/n/w/p/l/h/q).

Usage: python -m cilantro_tpu_torch.examples.visualizer [cloud.ply] [out_dir] [--device cpu]
"""

from __future__ import annotations

import os

import numpy as np

from .. import resolve_device
from ..viz import (
    CoordinateFrameRenderable,
    PointCloudRenderable,
    PointCorrespondencesRenderable,
    RenderingProperties,
    TextRenderable,
    Visualizer,
)
from ._common import load_cloud, out_dir, parser


def main(argv=None) -> int:
    ap = parser(__doc__, cloud=True, out=True)
    ap.add_argument("out_dir", nargs="?", default=None)
    args = ap.parse_args(argv)
    resolve_device(args.device)  # the scenes are built on the host
    out = out_dir(args.out, args.out_dir, name="cilantro_tpu_torch_viz")

    (pts, normals, colors), source = load_cloud(args.cloud, args.points)
    print(f"{len(pts)} points from {source}")

    # --- window 1: scalar-colormapped cloud + frame + text (visualizer.cpp:20-44)
    viz1 = Visualizer("Visualizer demo (window 1)", "disp1")
    scalars = np.linalg.norm(pts, axis=1)
    viz1.add_object(
        "pcd",
        PointCloudRenderable(
            (pts, normals, None),
            RenderingProperties(colormap_type="jet", line_density_fraction=0.2,
                                use_lighting=False),
        ),
    ).set_point_values(scalars)
    viz1.add_object(
        "axis",
        CoordinateFrameRenderable(np.eye(4), scale=0.4,
                                  rp=RenderingProperties(line_width=5.0)),
    )
    viz1.add_object(
        "text",
        TextRenderable(
            "Coordinate Frame", [0, 0, 0],
            RenderingProperties(font_size=20.0, point_color=(1.0, 1.0, 0.0),
                                text_anchor_point=(0.5, -1.0)),
        ),
    )
    p1 = viz1.export_html(os.path.join(out, "visualizer_window1.html"))
    print(f"window 1 -> {p1}")

    # --- window 2: blended clouds + correspondences (visualizer.cpp:46-67) --
    shifted = pts + np.array([1.0, 0.0, 1.0], np.float32)
    viz2 = Visualizer("Visualizer demo (window 2)", "disp2")
    viz2.add_object(
        "pcd1",
        PointCloudRenderable(
            pts, RenderingProperties(point_color=(1.0, 0.0, 0.0), opacity=0.4)
        ),
    )
    viz2.add_object(
        "pcd2",
        PointCloudRenderable(
            shifted, RenderingProperties(point_color=(0.0, 0.0, 1.0), opacity=0.4)
        ),
    )
    viz2.add_object(
        "correspondences",
        PointCorrespondencesRenderable(
            shifted, pts,
            rp=RenderingProperties(line_density_fraction=0.005, opacity=0.3),
        ),
    )
    viz2.add_object(
        "axis",
        CoordinateFrameRenderable(np.eye(4), scale=0.4,
                                  rp=RenderingProperties(line_width=5.0)),
    )
    p2 = viz2.export_html(os.path.join(out, "visualizer_window2.html"))
    print(f"window 2 -> {p2}")
    print("Press 'n' in the viewer to toggle rendering of normals")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
