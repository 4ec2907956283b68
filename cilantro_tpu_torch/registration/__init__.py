"""Transform estimation, rigid ICP and non-rigid warp fields (port of
``cilantro_tpu.registration``). The warp-field names are exported here as
the JAX package exports them; the rigid modules are imported by name
(``registration.icp``, ``registration.transform_estimation``)."""

from .warp_field import (  # noqa: F401
    DeformationGraph,
    build_deformation_graph,
    build_dense_graph,
    estimate_warp_field,
    icp_warp_field,
    icp_warp_field_projective,
    identity_warp,
    resample_transforms,
    warp_points,
)
from .warp_field_batched import (  # noqa: F401
    estimate_warp_field_batched,
    icp_warp_field_batched,
    identity_warp_batched,
    warp_points_batched,
)
