"""What the examples share: the synthetic stand-in for the reference's
``frame_1.ply``, the cloud loader and the common arguments."""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

HEIGHT_FIELD_POINTS = 120_000
HEIGHT_FIELD_SCALE = 0.36


def height_field(n: int = HEIGHT_FIELD_POINTS, seed: int = 0):
    """``(points, normals, None)``: the surface z = 0.2·sin(1.5x)·cos(1.5y)
    over [-1, 1]² at ``n`` points from ``default_rng(seed)``, scaled by
    0.36 (a 0.72 m patch, about as many points as ``frame_1.ply``'s
    120,111), with its exact unit normals (+z side) and no colours."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    z = (0.2 * np.sin(1.5 * xy[:, 0]) * np.cos(1.5 * xy[:, 1])).astype(np.float32)
    pts = np.column_stack([xy, z]) * np.float32(HEIGHT_FIELD_SCALE)
    u, v = 1.5 * xy[:, 0], 1.5 * xy[:, 1]
    zx, zy = 0.3 * np.cos(u) * np.cos(v), -0.3 * np.sin(u) * np.sin(v)
    nrm = np.stack([-zx, -zy, np.ones_like(zx)], axis=-1)
    return pts, (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32), None


def load_cloud(path, points: int = HEIGHT_FIELD_POINTS):
    """``((points, normals, colors), source)``: the PLY at ``path``, or
    :func:`height_field` of ``points`` points when ``path`` is None."""
    if path:
        from ..utils.ply_io import read_point_cloud

        return read_point_cloud(path), path
    return height_field(points), f"a synthetic height field (seed 0, {HEIGHT_FIELD_SCALE * 2:.2f} m patch)"


def parser(doc: str, *, cloud: bool = False, out: bool = False) -> argparse.ArgumentParser:
    """An argument parser with ``--device`` (default ``cuda``); with
    ``cloud`` the optional positional PLY path and ``--points`` (the
    synthetic input's size), with ``out`` the ``--out`` directory."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    if cloud:
        ap.add_argument("cloud", nargs="?", default=None,
                        help="a PLY file (default: a synthetic height field)")
        ap.add_argument("--points", type=int, default=HEIGHT_FIELD_POINTS,
                        help="points of the synthetic height field")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain PyTorch versions)")
    if out:
        ap.add_argument("--out", default=None, help="directory for the files it writes")
    return ap


def out_dir(*choices, name: str) -> str:
    """The first of ``choices`` that is set, else ``<tempdir>/name``; made
    if missing."""
    path = next((c for c in choices if c), None) or os.path.join(tempfile.gettempdir(), name)
    os.makedirs(path, exist_ok=True)
    return path


def generator(seed: int, device):
    """A ``torch.Generator`` on ``device`` seeded with ``seed``: where the
    JAX script takes ``jax.random.PRNGKey(seed)``."""
    import torch

    return torch.Generator(device=device).manual_seed(seed)


def scaled_intrinsics(h: int, w: int):
    """The Kinect's 640×480 intrinsics at 640×480, scaled to other sizes
    as the SLAM demo scales them."""
    from ..core.rgbd import CameraIntrinsics

    if (h, w) == (480, 640):
        return CameraIntrinsics.kinect_640()
    return CameraIntrinsics.make(fx=w * 525.0 / 640.0, fy=w * 525.0 / 640.0, cx=(w - 1) / 2.0, cy=(h - 1) / 2.0)
