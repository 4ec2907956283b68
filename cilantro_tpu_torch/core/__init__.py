"""Transforms, point clouds, voxel grids and RGBD conversions (port of
``cilantro_tpu.core``)."""
