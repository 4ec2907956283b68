"""Exact nearest-neighbour and radius search (port of
``cilantro_tpu.neighbors``): the ``knn_search`` / ``radius_search`` API,
brute force with the nn1 and kNN kernels (``fused_nn``, ``fused_knn``, the
counterparts of the JAX package's ``pallas_nn``), the Morton-tile prune
plans and the grid radius search."""

from .api import (  # noqa: F401
    Neighborhoods,
    knn_search,
    radius_search,
    knn_in_radius_search,
)
from .bruteforce import knn, nn1, INVALID_DIST  # noqa: F401
from .gridhash import radius_search_grid  # noqa: F401
from .fused_nn import (  # noqa: F401
    NN1PrunePlan,
    make_nn1_prune_plan,
    nn1_pruned,
    nn1_pruned_planned,
)
from .fused_knn import knn_pruned, radius_search_pruned  # noqa: F401
