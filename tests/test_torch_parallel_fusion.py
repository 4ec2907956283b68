"""The port's map-sharded fusion (``cilantro_tpu_torch/parallel/
sharded_fusion.py``) on a gloo group of 2 subprocess ranks against the JAX
package's on a (1, 2) mesh of the conftest's virtual CPU devices, at
``tests/test_sharded_fusion.py``'s shape (48×64, pools of 2·H·W and of
1,024 rows).

Both packages start from the same state: the JAX run's frames (points,
normals, validity) and its seeded pool, cut into the port's shards by
``interop.sharded_map_from_numpy``. Tolerances: the port's own seeding
(``init_sharded_map``) equals JAX's layout bit for bit; each frame's pose
within 1e-5 of JAX's; the same live-row count on each shard; the same
winner image (no z-buffer tie flips at this shape: the winners would be
allowed to differ only there); the final pools' live rows within 1e-5
(measured 1.9e-6); every replicated output (poses, winner images)
bit-identical across ranks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cilantro_tpu.core.rgbd import CameraIntrinsics, depth_to_points_normals
from cilantro_tpu.core.transforms import identity
from cilantro_tpu.parallel.sharded import make_mesh
from cilantro_tpu.parallel.sharded_fusion import init_sharded_map, sharded_fusion_step
from cilantro_tpu.slam import FusionConfig, synthetic_sequence
from cilantro_tpu.slam.fusion import _valid_col
from torch_parallel_ranks import Ranks
from torch_parallel_worker import FUSION_HW, FUSION_K

WORLD = 2
H, W = FUSION_HW
K = CameraIntrinsics.make(*FUSION_K)
# (run, frames, seed, capacity, seeded pixels): the two runs of
# tests/test_sharded_fusion.py.
RUNS = (("run", 4, 5, 2 * H * W, None), ("small", 3, 6, 1024, 900))


def _jax_runs():
    """JAX's runs with their inputs: frames, seeded pool, and each step's
    pose and winner image."""
    mesh = make_mesh(1, WORLD, devices=jax.devices()[:WORLD])
    inputs, runs = {}, {}
    for name, frames, seed, cap, seed_rows in RUNS:
        depths, _ = synthetic_sequence(frames, H, W, K, seed=seed)
        fr = [depth_to_points_normals(jnp.asarray(d), K) for d in depths]
        val0 = np.asarray(fr[0][2])
        if seed_rows is not None:
            val0 = val0 & (np.arange(H * W) < seed_rows)
        sdata = init_sharded_map(mesh, cap, fr[0][0], fr[0][1], None, jnp.asarray(val0))
        inputs.update({
            f"{name}_points": np.stack([np.asarray(f[0]) for f in fr]),
            f"{name}_normals": np.stack([np.asarray(f[1]) for f in fr]),
            f"{name}_valid": np.stack([np.asarray(f[2]) for f in fr]),
            f"{name}_seed_valid": val0, f"{name}_capacity": np.int64(cap),
            f"{name}_seed_pool": np.asarray(sdata),
        })
        rec = {"seed": np.asarray(sdata), "poses": [], "widx": []}
        pose = identity(3)
        for fi in range(1, frames):
            sdata, pose, widx = sharded_fusion_step(sdata, *fr[fi][:2], None, fr[fi][2], pose, K, mesh=mesh,
                                                    height=H, width=W, cfg=FusionConfig())
            rec["poses"].append(np.asarray(pose.matrix()))
            rec["widx"].append(np.asarray(widx))
        rec["data"] = np.asarray(sdata)
        runs[name] = rec
    return inputs, runs


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    # JAX's frames and seeded pools are the ranks' inputs, so JAX runs first.
    inputs, jruns = _jax_runs()
    ranks = Ranks("fusion", WORLD, tmp_path_factory.mktemp("fusion"), inputs)
    return jruns, ranks.results()


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_seeding_deals_as_jax(both, name):
    jruns, res = both
    assert np.array_equal(np.concatenate([r[name]["seed"] for r in res]), jruns[name]["seed"])


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_steps_match_jax(both, name):
    jruns, res = both
    jrun = jruns[name]
    for i, (jp, tp) in enumerate(zip(jrun["poses"], res[0][name]["poses"])):
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-5, err_msg=f"frame {i + 1}")
    data = np.concatenate([r[name]["data"] for r in res])
    vcol = _valid_col(data.shape[1])
    c_local = data.shape[0] // WORLD
    for d in range(WORLD):
        shard = slice(d * c_local, (d + 1) * c_local)
        assert int((data[shard, vcol] > 0.5).sum()) == int((jrun["data"][shard, vcol] > 0.5).sum()), d
    live = data[:, vcol] > 0.5
    assert np.isfinite(data[live]).all()
    for i, (jw, tw) in enumerate(zip(jrun["widx"], res[0][name]["widx"])):
        assert np.array_equal(tw, jw), f"frame {i + 1}"
    np.testing.assert_allclose(data[live], jrun["data"][live], rtol=0, atol=1e-5)


def test_small_pool_fills_and_drops(both):
    """tests/test_sharded_fusion.py::test_uneven_capacity_padding's bounds:
    augments past a shard's capacity drop; the pool fills."""
    _, res = both
    data = np.concatenate([r["small"]["data"] for r in res])
    n_valid = int((data[:, _valid_col(data.shape[1])] > 0.5).sum())
    assert 0.9 * 1024 < n_valid <= 1024


def test_replicated_outputs_are_identical_across_ranks(both):
    _, res = both
    for name, *_ in RUNS:
        for key in ("poses", "widx"):
            for a, b in zip(res[0][name][key], res[1][name][key]):
                assert np.array_equal(a, b), (name, key)
