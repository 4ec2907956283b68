"""Depth clips of the wavy room, rendered on the device from a seed.

The scene, the camera's random walk, the z-buffer and the 3×3 hole fill
are those of the measured package's ``synthetic_sequence``: a height field
``z = 2 + 0.25 sin 2x cos 1.5y + 0.05 sin 7x`` sampled 4 times a pixel,
seen from a camera that yaws and drifts by ``motion_scale`` a frame. The
walk is drawn on the host from ``numpy.random.default_rng(clip seed)``
exactly as there, so the poses are the same bits; the render runs as a
few large tensor operations, so a clip costs milliseconds, not seconds.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def clip_seed(seed: int, index: int) -> int:
    """The seed of clip ``index`` of a run seeded ``seed`` (any integer)."""
    return (seed % 2**62) * 1000 + index


def walk(num_frames: int, seed: int, motion_scale: float) -> List[np.ndarray]:
    """Camera-to-world poses ``(4, 4)`` float32 of the random walk."""
    rng = np.random.default_rng(seed)
    poses = []
    ang = 0.0
    pos = np.zeros(3)
    vel = rng.standard_normal(3) * motion_scale
    for _ in range(num_frames):
        r = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]],
                     np.float32)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = r
        pose[:3, 3] = pos
        poses.append(pose)
        ang += rng.standard_normal() * motion_scale
        vel = 0.9 * vel + rng.standard_normal(3) * motion_scale * 0.5
        pos = pos + vel
    return poses


def scene(h: int, w: int, device) -> torch.Tensor:
    """The height field's ``(4·H·W, 3)`` float32 sample points."""
    gx, gy = np.meshgrid(np.linspace(-1.6, 1.6, 2 * w), np.linspace(-1.2, 1.2, 2 * h))
    gz = 2.0 + 0.25 * np.sin(2.0 * gx) * np.cos(1.5 * gy) + 0.05 * np.sin(7.0 * gx)
    pts = np.column_stack([gx.ravel(), gy.ravel(), gz.ravel()]).astype(np.float32)
    return torch.as_tensor(pts, device=device)


def render(points: torch.Tensor, poses: torch.Tensor, sensor: dict) -> torch.Tensor:
    """Depth images ``(F, H, W)`` of ``points`` seen from camera-to-world
    ``poses (F, 4, 4)``: the nearest sample a pixel (0 where none), holes
    filled with the farthest of their 3×3 neighbours."""
    h, w = sensor["height"], sensor["width"]
    fx, fy, cx, cy = (float(np.float32(sensor[k])) for k in ("fx", "fy", "cx", "cy"))
    frames = []
    for pose in poses:
        cam = (points - pose[:3, 3]) @ pose[:3, :3]
        z = cam[:, 2]
        ok = z > 0
        zs = torch.where(ok, z, 1.0)
        u = torch.round(cam[:, 0] * fx / zs + cx).to(torch.int64)
        v = torch.round(cam[:, 1] * fy / zs + cy).to(torch.int64)
        ok &= (u >= 0) & (u < w) & (v >= 0) & (v < h)
        pix = torch.where(ok, v * w + u, h * w)
        zbuf = torch.full((h * w + 1,), float("inf"), dtype=torch.float32, device=points.device)
        zbuf.scatter_reduce_(0, pix, torch.where(ok, z, float("inf")), "amin")
        d = torch.where(torch.isinf(zbuf[:-1]), 0.0, zbuf[:-1]).reshape(h, w)
        filled = F.max_pool2d(d[None, None], 3, stride=1, padding=1)[0, 0]
        frames.append(torch.where(d == 0, filled, d))
    return torch.stack(frames)


def make_clips(seed: int, count: int, frames: int, sensor: dict, motion_scale: float, device
               ) -> Tuple[np.ndarray, np.ndarray]:
    """``count`` clips of ``frames`` depth images: ``(depths (count, F, H,
    W) float32 on the host, ground-truth poses (count, F, 4, 4))``."""
    pts = scene(sensor["height"], sensor["width"], device)
    depths, truth = [], []
    for i in range(count):
        poses = np.stack(walk(frames, clip_seed(seed, i), motion_scale))
        depths.append(render(pts, torch.as_tensor(poses, device=device), sensor).cpu().numpy())
        truth.append(poses)
    return np.stack(depths), np.stack(truth)
