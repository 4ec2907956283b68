"""Checks of the port's SLAM module that need neither package's
``run_slam`` (``tests/test_torch_slam_loop.py`` runs both once per module
in its fixtures): the panorama sequence both packages render, a sequence
integrated at known poses through both, and the scanned front end's one
pass. They live in a file of their own so that a run that gives whole
files to its workers can take them apart from those fixtures."""

import numpy as np
import pytest
import torch

from cilantro_tpu import slam as jslam
from cilantro_tpu.core.rgbd import CameraIntrinsics as JIntrinsics
from cilantro_tpu_torch import slam as tslam
from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
from cilantro_tpu_torch.slam.fusion import FusionConfig

H, W, FRAMES = 72, 96, 48


def _intr(cls):
    return cls.make(fx=W * 525.0 / 640.0, fy=W * 525.0 / 640.0, cx=(W - 1) / 2.0, cy=(H - 1) / 2.0)


K, JK = _intr(CameraIntrinsics), _intr(JIntrinsics)


@pytest.fixture(scope="module")
def sequence():
    return jslam.synthetic_panorama_sequence(FRAMES, H, W, JK, seed=3, depth_noise=0.008)


def test_panorama_sequence_matches_jax(sequence):
    depths, gt = sequence
    for args in ((FRAMES, H, W), (6, 40, 56)):
        kw = dict(seed=3, depth_noise=0.008) if args[0] == FRAMES else dict(seed=1, depth_noise=0.0,
                                                                             sweep_deg=60.0)
        want = (depths, gt) if args[0] == FRAMES else jslam.synthetic_panorama_sequence(*args, JK, **kw)
        got = tslam.synthetic_panorama_sequence(*args, K, **kw)
        for a, b in zip(want[0] + want[1], got[0] + got[1]):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_integrate_sequence_at_known_poses():
    """``tests/test_slam_loop.py::test_integrate_sequence_at_known_poses``
    through both packages: the same live points within 0.5% and within
    1e-5 m where both pools hold a point at a slot, and the JAX test's
    bound on the port's map."""
    depths, gt = jslam.synthetic_panorama_sequence(6, H, W, JK, seed=1, depth_noise=0.0, sweep_deg=60.0)
    jmap = jslam.integrate_sequence(depths, gt, JK, map_capacity=8 * H * W)
    tmap = tslam.integrate_sequence(depths, gt, K, map_capacity=8 * H * W, device="cpu")
    jvalid, tvalid = np.asarray(jmap.valid), tmap.valid.numpy()
    assert abs(int(tvalid.sum()) - int(jvalid.sum())) <= 0.005 * jvalid.sum()
    both = jvalid & tvalid
    assert both.sum() >= 0.99 * jvalid.sum()
    close = np.all(np.abs(tmap.points.numpy()[both] - np.asarray(jmap.points)[both]) < 1e-5, axis=1)
    assert close.mean() > 0.99
    pts = tmap.points[tmap.valid].numpy()
    rad = np.linalg.norm(pts[:, [0, 2]], axis=1)
    assert (np.abs(rad - 2.5) < 0.7).mean() > 0.98


def test_scanned_front_end_takes_one_pass(monkeypatch):
    """``run_slam(frontend="scanned")`` takes its odometry from one pass of
    the scanned driver's step (the public driver makes three timed passes
    and, on the card, an untimed one): the same poses as the public driver,
    a third of its steps."""
    from cilantro_tpu_torch.slam import driver, scan

    k = CameraIntrinsics.make(100.0, 100.0, 31.5, 23.5)
    depths, _ = tslam.synthetic_sequence(5, 48, 64, k, seed=3)
    steps = []
    real = scan.scan

    def counted(step, *args, **kwargs):
        def one(carry, x):
            steps.append(1)
            return step(carry, x)
        return real(one, *args, **kwargs)

    monkeypatch.setattr(driver, "scan", counted)
    _, public = driver.run_fusion_sequence_scanned(depths, k, device="cpu")
    n_public = len(steps)
    _, one_pass = driver._fusion_scanned(depths, k, None, FusionConfig(), torch.device("cpu"), None, 1)
    assert n_public == 3 * (len(depths) - 1) and len(steps) - n_public == len(depths) - 1
    for a, b in zip(public.poses, one_pass.poses):
        assert np.array_equal(a, b)
