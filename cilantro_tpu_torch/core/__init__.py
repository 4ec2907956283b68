"""Transforms, point clouds, voxel grids, covariance, normals, PCA and RGBD
conversions (port of ``cilantro_tpu.core``)."""

from .containers import PointCloud, from_numpy, compact, append  # noqa: F401
from .transforms import (  # noqa: F401
    Transform,
    identity,
    from_matrix,
    compose,
    inverse,
    transform_points,
    transform_normals,
    transform_points_normals,
    project_to_rotation,
    reproject_rigid,
)
from .covariance import (  # noqa: F401
    mean_and_covariance,
    neighborhood_mean_cov,
    mcd_mean_cov,
    mahalanobis2,
)
from .normals import (  # noqa: F401
    estimate_normals_knn,
    estimate_normals_radius,
    estimate_normals_knn_in_radius,
    normals_from_neighborhoods,
)
from .grid import grid_downsample, build_grid_bins, grid_bin_ids, voxel_coords  # noqa: F401
from .pca import PCA, fit_pca  # noqa: F401
from .rgbd import (  # noqa: F401
    CameraIntrinsics,
    depth_to_metric,
    depth_to_points,
    depth_to_points_normals,
    rgbd_to_cloud,
    project_points,
    points_to_index_map,
    points_to_depth_image,
    cloud_to_rgbd,
)
from . import pair_evaluators  # noqa: F401
