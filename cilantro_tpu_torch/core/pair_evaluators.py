"""Pair evaluators (port of ``cilantro_tpu/core/pair_evaluators.py``).

Each evaluator is a callable ``(i, j, value) -> weight or bool`` over
tensors of index pairs: weight evaluators return floats, proximity
evaluators boolean masks. A negative ``max_angle`` compares normals
regardless of orientation.
"""

from __future__ import annotations

import math

import torch


def identity_weight(i, j, value):
    """``IdentityWeightEvaluator`` / ``DistanceEvaluator``."""
    return value


def unity_weight(i, j, value):
    """``UnityWeightEvaluator`` / ``AdjacencyEvaluator``."""
    return torch.ones_like(value)


def rbf_kernel_weight(sigma: float, distances_are_squared: bool = True):
    """``RBFKernelWeightEvaluator``: ``exp(-d²/(2σ²))``."""
    coeff = -0.5 / (sigma * sigma)

    def ev(i, j, value):
        d2 = value if distances_are_squared else value * value
        return torch.exp(coeff * d2)

    return ev


def points_proximity(max_distance: float):
    """``PointsProximityEvaluator``: squared-distance gate."""

    def ev(i, j, dist):
        return dist < max_distance

    return ev


def _normal_angle_ok(normals, i, j, max_angle: float):
    i, j = torch.as_tensor(i).long(), torch.as_tensor(j).long()
    dots = torch.clamp(torch.sum(normals[i] * normals[j], dim=-1), -1.0, 1.0)
    angle = torch.arccos(dots)
    if max_angle >= 0.0:
        return angle < max_angle
    return torch.minimum(angle, math.pi - angle) < -max_angle


def normals_proximity(normals, max_angle: float):
    """``NormalsProximityEvaluator``: normal-angle gate."""

    def ev(i, j, value):
        return _normal_angle_ok(normals, i, j, max_angle)

    return ev


def colors_proximity(colors, max_color_diff: float):
    """``ColorsProximityEvaluator``: RGB L2 gate."""
    thresh = max_color_diff * max_color_diff

    def ev(i, j, value):
        diff = colors[torch.as_tensor(i).long()] - colors[torch.as_tensor(j).long()]
        return torch.sum(diff * diff, dim=-1) < thresh

    return ev


def points_normals_proximity(normals, max_distance: float, max_angle: float):
    """``PointsNormalsProximityEvaluator``."""

    def ev(i, j, dist):
        return (dist < max_distance) & _normal_angle_ok(normals, i, j, max_angle)

    return ev


def points_colors_proximity(colors, max_distance: float, max_color_diff: float):
    """``PointsColorsProximityEvaluator``."""
    col = colors_proximity(colors, max_color_diff)

    def ev(i, j, dist):
        return (dist < max_distance) & col(i, j, dist)

    return ev


def normals_colors_proximity(normals, colors, max_angle: float, max_color_diff: float):
    """``NormalsColorsProximityEvaluator``."""
    col = colors_proximity(colors, max_color_diff)

    def ev(i, j, value):
        return col(i, j, value) & _normal_angle_ok(normals, i, j, max_angle)

    return ev


def points_normals_colors_proximity(
    normals,
    colors,
    max_distance: float,
    max_angle: float,
    max_color_diff: float,
):
    """``PointsNormalsColorsProximityEvaluator``: the distance, normal-angle
    and colour gate of connected-component segmentation."""
    nc = normals_colors_proximity(normals, colors, max_angle, max_color_diff)

    def ev(i, j, dist):
        return (dist < max_distance) & nc(i, j, dist)

    return ev
