"""The clip generator: deterministic by seed, distinct across seeds and
clips, and the measured package's synthetic renderer's poses and depths."""

import numpy as np
import pytest

from portbench import clips

SENSOR = {"height": 48, "width": 64, "fx": 52.5, "fy": 52.5, "cx": 31.5, "cy": 23.5}


def test_same_seed_same_clips():
    a = clips.make_clips(2**31 + 17, 2, 4, SENSOR, 0.004, "cpu")
    b = clips.make_clips(2**31 + 17, 2, 4, SENSOR, 0.004, "cpu")
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_seeds_and_clips_differ():
    d1, p1 = clips.make_clips(5, 2, 4, SENSOR, 0.004, "cpu")
    d2, p2 = clips.make_clips(6, 2, 4, SENSOR, 0.004, "cpu")
    assert not np.array_equal(p1[0], p1[1])
    assert not np.array_equal(p1, p2)
    assert not np.array_equal(d1, d2)
    assert np.all(d1 >= 0) and np.mean(d1 > 0) > 0.9


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 1])
def test_matches_synthetic_sequence(seed):
    from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
    from cilantro_tpu_torch.slam.driver import synthetic_sequence

    k = CameraIntrinsics.make(SENSOR["fx"], SENSOR["fy"], SENSOR["cx"], SENSOR["cy"])
    depths, truth = clips.make_clips(seed, 1, 5, SENSOR, 0.004, "cpu")
    ref_d, ref_p = synthetic_sequence(5, 48, 64, k, seed=clips.clip_seed(seed, 0))
    np.testing.assert_array_equal(truth[0], np.stack(ref_p))
    ref_d = np.stack(ref_d)
    # Float32 rounding of a projection may move a sample across a pixel
    # edge; nearly every pixel is the same bits.
    same = np.mean(depths[0] == ref_d)
    assert same > 0.99, same
    assert np.max(np.abs(depths[0] - ref_d)) < 0.05
