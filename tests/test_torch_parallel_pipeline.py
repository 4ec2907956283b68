"""The port's two-rank pipeline (``run_fusion_sequence_pipelined`` on a
``("pipe",)`` mesh: the front end on rank 0, the tracker on rank 1, the
frame in flight sent across each step) on a gloo group of 2 subprocess
ranks, at ``tests/test_pipeline.py``'s shape (6 frames of 48×64, a pool
of 2·H·W).

Held bit for bit to the port's scanned driver (run by each rank with the
same one thread), as ``tests/test_pipeline.py`` holds JAX's pipeline to
JAX's scanned driver; then to JAX's two-device pipeline within that
test's tolerances (poses and pool within 1e-5, the same ICP iterations,
ATE below 5e-3 m); and the same on both ranks."""

import jax
import numpy as np
import pytest

from cilantro_tpu.core.rgbd import CameraIntrinsics
from cilantro_tpu.slam import FusionConfig, ate_rmse, make_pipeline_mesh, run_fusion_sequence_pipelined
from cilantro_tpu.slam import synthetic_sequence
from torch_parallel_ranks import Ranks
from torch_parallel_worker import FUSION_HW, FUSION_K

H, W = FUSION_HW
K = CameraIntrinsics.make(*FUSION_K)


@pytest.fixture(scope="module")
def sequence():
    return synthetic_sequence(6, H, W, K, seed=3)


@pytest.fixture(scope="module")
def ranks(sequence, tmp_path_factory):
    depths, _ = sequence
    return Ranks("pipeline", 2, tmp_path_factory.mktemp("pipeline"), {"depths": np.stack(depths)})


def test_two_ranks_match_the_scanned_driver_bit_for_bit(ranks):
    for r in ranks.results():
        p, s = r["pipelined"], r["scanned"]
        assert np.array_equal(p["poses"], s["poses"])
        assert p["iterations"] == s["iterations"]
        assert np.array_equal(p["data"], s["data"])


def test_two_ranks_match_jax_pipeline(ranks, sequence):
    depths, gt = sequence
    mesh = make_pipeline_mesh(jax.devices()[:2])
    fmap, met = run_fusion_sequence_pipelined(depths, K, mesh=mesh, map_capacity=2 * H * W, cfg=FusionConfig())
    res = ranks.results()
    for r in res:
        p = r["pipelined"]
        np.testing.assert_allclose(p["poses"], np.stack(met.poses), rtol=0, atol=1e-5)
        assert p["iterations"] == met.icp_iterations
        np.testing.assert_allclose(p["data"], np.asarray(fmap.data), rtol=0, atol=1e-5)
        assert ate_rmse(list(p["poses"]), gt) < 5e-3
    assert [r["pipelined"]["rank"] for r in res] == [0, 1]
    for key in ("poses", "iterations", "data"):
        assert np.array_equal(np.asarray(res[0]["pipelined"][key]), np.asarray(res[1]["pipelined"][key])), key
