"""Visualization (port of ``cilantro_tpu.viz``): renders through the
port's z-buffer on the card, PNG artefacts (matplotlib, optional), the
standalone interactive WebGL page and the fusion drivers' live snapshot
hook."""

from .offline import (  # noqa: F401
    render_cloud_image,
    save_cloud_png,
    save_trajectory_png,
    dump_artifacts,
    auto_camera,
)
from .interactive import (  # noqa: F401
    RenderingProperties,
    Renderable,
    PointCloudRenderable,
    PointCorrespondencesRenderable,
    CoordinateFrameRenderable,
    CameraFrustumRenderable,
    TriangleMeshRenderable,
    TextRenderable,
    Visualizer,
    ImageViewer,
)
from .live import LiveMapViewer  # noqa: F401
