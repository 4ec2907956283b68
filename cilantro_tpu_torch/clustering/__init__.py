"""Clustering (port of ``cilantro_tpu.clustering``): k-means, mean shift,
connected components and spectral clustering."""

from .kmeans import KMeansResult, kmeans  # noqa: F401
from .mean_shift import MeanShiftResult, mean_shift  # noqa: F401
from .connected_components import (  # noqa: F401
    ConnectedComponents,
    connected_components,
    edge_mask_from_evaluator,
    propagate_labels,
)
from .spectral import (  # noqa: F401
    SpectralResult,
    laplacian,
    spectral_embedding,
    spectral_embedding_knn,
    spectral_clustering,
    spectral_clustering_knn,
    estimate_num_clusters_eigengap,
)
