"""Robust model estimation (port of ``cilantro_tpu.model_estimation``):
batched RANSAC for planes and rigid / affine transforms."""

from .ransac import (  # noqa: F401
    Hyperplane,
    RANSACResult,
    ransac_plane,
    ransac_transform,
)
