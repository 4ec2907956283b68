"""Correspondence search (port of ``cilantro_tpu.correspondence``)."""

from .search import (  # noqa: F401
    Correspondences,
    point_features,
    point_normal_features,
    find_nn_correspondences,
    find_nn_correspondences_bidirectional,
    oracle_correspondences,
)
from .projective import (  # noqa: F401
    build_projective_target,
    find_projective_correspondences,
)
