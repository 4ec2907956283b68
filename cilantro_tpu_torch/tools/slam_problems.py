"""The SLAM backend's test problems, drawn as the JAX package's tests draw
them (``tests/test_slam_backend.py``), in numpy: shared by the port's CPU
tests, its card tests and ``chip_smoke.py`` phases 26-27. Importing this
module runs nothing."""

from __future__ import annotations

import numpy as np
import torch

from ..core.transforms import axis_angle_to_rotation


def rand_rot(rng, scale=0.05):
    """A rotation about a random axis by an angle of ``scale``·N(0, 1)
    (``tests/test_slam_backend.py``'s ``rand_rot``, float64)."""
    w = rng.standard_normal(3) * scale
    th = np.linalg.norm(w)
    ax = w / max(th, 1e-9)
    kk = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
    return np.eye(3) + np.sin(th) * kk + (1 - np.cos(th)) * kk @ kk


def pose_graph_chain(rng, kp=6):
    """``tests/test_slam_backend.py:99``'s chain, drawn in its order: the
    true poses, a perturbed start, the edges (odometry and one loop) and
    their exact measurements. Returns ``(true, init, edge_i, edge_j, z)``
    (float64 matrices, int32 edges)."""
    true = [np.eye(4)]
    for _ in range(1, kp):
        t4 = np.eye(4)
        t4[:3, :3] = rand_rot(rng, 0.2)
        t4[:3, 3] = rng.standard_normal(3) * 0.3
        true.append(true[-1] @ t4)
    edges = [(i, i + 1) for i in range(kp - 1)] + [(0, kp - 1)]
    ei = np.array([e[0] for e in edges], np.int32)
    ej = np.array([e[1] for e in edges], np.int32)
    z = [np.linalg.inv(true[a]) @ true[b] for a, b in edges]
    init = [true[0]] + [t.copy() for t in true[1:]]
    for t4 in init[1:]:
        t4[:3, :3] = rand_rot(rng, 0.04) @ t4[:3, :3]
        t4[:3, 3] += rng.standard_normal(3) * 0.04
    return true, init, ei, ej, z


def small_ba_problem(rng):
    """``tests/test_slam_backend.py:28``'s problem (4 cameras, 64 landmarks,
    perturbed poses and landmarks), drawn in its order. Returns the numpy
    problem ``(linear, translation, landmarks, cam_idx, lmk_idx, obs)``
    (float32 / int32) and the truth ``(rotations, translations)``."""
    k_, l = 4, 64
    true_r = [np.eye(3)] + [rand_rot(rng, 0.3) for _ in range(k_ - 1)]
    true_t = [np.zeros(3)] + [rng.standard_normal(3) * 0.5 for _ in range(k_ - 1)]
    x = rng.standard_normal((l, 3)) + np.array([0, 0, 5.0])
    cam_idx = np.repeat(np.arange(k_), l)
    lmk_idx = np.tile(np.arange(l), k_)
    obs = np.concatenate([(x - t) @ r for r, t in zip(true_r, true_t)])
    init_r = [true_r[0]] + [rand_rot(rng, 0.05) @ r for r in true_r[1:]]
    init_t = [true_t[0]] + [t + rng.standard_normal(3) * 0.05 for t in true_t[1:]]
    x0 = x + rng.standard_normal((l, 3)) * 0.05
    problem = (
        np.stack(init_r).astype(np.float32), np.stack(init_t).astype(np.float32),
        x0.astype(np.float32), cam_idx.astype(np.int32), lmk_idx.astype(np.int32),
        obs.astype(np.float32),
    )
    return problem, (true_r, true_t)


def mapping_ba_problem(k, l, o, seed=0):
    """tests/test_slam_backend.py:133's problem at ``(k, l, o)``: cameras on
    an arc, 1 mm observation noise, the translations and landmarks moved by
    1 cm; numpy, drawn in that test's order."""
    rng = np.random.default_rng(seed)
    lmk = rng.uniform(-2, 2, (l, 3)).astype(np.float32)
    angles = np.linspace(0, 0.5, k).astype(np.float32)
    r_true = np.stack([axis_angle_to_rotation(torch.tensor([0.0, a, 0.0])).numpy() for a in angles])
    t_true = rng.uniform(-0.5, 0.5, (k, 3)).astype(np.float32)
    cam_idx = rng.integers(0, k, o).astype(np.int32)
    lmk_idx = rng.integers(0, l, o).astype(np.int32)
    x_c = np.einsum("oji,oj->oi", r_true[cam_idx], lmk[lmk_idx] - t_true[cam_idx])
    obs = (x_c + rng.standard_normal((o, 3)) * 1e-3).astype(np.float32)
    t0 = (t_true + rng.standard_normal((k, 3)) * 0.01).astype(np.float32)
    lmk0 = (lmk + rng.standard_normal((l, 3)) * 0.01).astype(np.float32)
    return r_true, t0, lmk0, cam_idx, lmk_idx, obs
