"""The port's ``dryrun_multichip`` (``cilantro_tpu_torch/entry.py``): its
parts on a gloo group of 2 subprocess ranks (the worker's ``dryrun``
suite, which calls the entry's part helpers with the entry's meshes and
draws) against the JAX calls that ``__graft_entry__.py::dryrun_multichip``
makes, on meshes of the same shapes over the conftest's virtual CPU
devices, on the same numpy inputs. ``tests/test_torch_dryrun_world4.py``
runs the same tests on 4 ranks with its own ``world`` fixture.

The ICPs, the BA and the warp run at the entry's own shapes (1,024
points, 16·n landmarks, 128·n warp points). The two fusion runs and the
pipeline run at ``tests/test_torch_parallel_fusion.py``'s 48×64 shape
instead of 640×480 and 320×240 (JAX's sharded fusion at 640×480 would
spend minutes compiling on this CPU), with the entry's frame counts, pool
sizes per pixel, seed and stride-2 localize.

Tolerances, those of ``tests/test_torch_parallel_{icp,ba,warp,fusion}.py``:
the tournament and ring ICP within 1e-5 with the same iteration count, the
BA's poses and landmarks within 1e-4, the warp's node transforms within
1e-4, each fusion pose within 1e-5 of JAX's; the pipeline bit for bit the
port's scanned driver and its poses within 1e-5 of JAX's pipeline; every
replicated output bit-identical across ranks. Then
``dryrun_multichip(1, device="cpu")`` runs whole at its real shapes (about
5 s on one torch thread), and a world size the process group does not have raises
``ValueError``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cilantro_tpu.core.rgbd import CameraIntrinsics, depth_to_points_normals
from cilantro_tpu.core.transforms import Transform, identity
from cilantro_tpu.parallel import make_mesh, shard_cloud_arrays, sharded_combined_icp
from cilantro_tpu.parallel import sharded_combined_icp_ring, sharded_estimate_warp_field
from cilantro_tpu.parallel.sharded_fusion import init_sharded_map, sharded_fusion_step
from cilantro_tpu.registration import build_deformation_graph
from cilantro_tpu.slam import FusionConfig, bundle_adjust_sharded, make_pipeline_mesh
from cilantro_tpu.slam import run_fusion_sequence_pipelined, synthetic_sequence
from cilantro_tpu_torch import entry
from torch_examples_run import one_torch_thread  # noqa: F401
from torch_parallel_ranks import Ranks
from torch_parallel_worker import DRYRUN_FUSION, FUSION_HW, FUSION_K

H, W = FUSION_HW
K = CameraIntrinsics.make(*FUSION_K)


def _inputs():
    """The fusion runs' frames (JAX's renderer, seed 1 as the entry's) and
    pool sizes."""
    out = {}
    for name, (frames, pool) in DRYRUN_FUSION.items():
        depths, _ = synthetic_sequence(frames, H, W, K, seed=1)
        out[f"{name}_depths"] = np.stack(depths)
        out[f"{name}_capacity"] = np.int64(pool * H * W)
    return out


def _tf(tf):
    return {"linear": np.asarray(tf.linear), "translation": np.asarray(tf.translation)}


def _jax_parts(n, inputs):
    """``__graft_entry__.py::dryrun_multichip``'s calls at ``n`` devices,
    the fusion runs and the pipeline on the small frames."""
    devs = jax.devices()[:n]
    out = {}
    pts, dst, nrm = entry._toy_pair(n=1024)
    ones = np.ones(len(pts), bool)
    mesh = make_mesh(*entry._icp_mesh_shape(n), devices=devs)
    tf, it = sharded_combined_icp(*shard_cloud_arrays(mesh, "points", pts, ones),
                                  *shard_cloud_arrays(mesh, "map", dst, nrm, ones), mesh=mesh,
                                  max_corr_dist_sq=0.25, max_iterations=2, point_weight=0.3)
    out["tournament"] = dict(_tf(tf), iterations=int(it))

    line_mesh = make_mesh(n, 1, devices=devs)
    rng = np.random.default_rng(0)
    lmk, cam, local, obs, valid = entry._ba_problem(n, rng)
    poses0 = Transform(jnp.broadcast_to(jnp.eye(3), (4, 3, 3)), jnp.zeros((4, 3)))
    p_out, l_out, resid = bundle_adjust_sharded(
        poses0, *shard_cloud_arrays(line_mesh, "points", lmk, cam, local, obs, valid), mesh=line_mesh,
        max_iterations=2)
    out["ba"] = dict(_tf(p_out), landmarks=np.asarray(l_out), residual=float(resid))

    tf, it = sharded_combined_icp_ring(*shard_cloud_arrays(line_mesh, "points", pts, ones, dst, nrm, ones),
                                       mesh=line_mesh, max_corr_dist_sq=0.25, max_iterations=2, point_weight=0.3)
    out["ring"] = dict(_tf(tf), iterations=int(it))

    fusion_mesh = make_mesh(1, n, devices=devs)
    for name in DRYRUN_FUSION:
        frames = [depth_to_points_normals(jnp.asarray(d), K) for d in inputs[f"{name}_depths"]]
        sdata = init_sharded_map(fusion_mesh, int(inputs[f"{name}_capacity"]), *frames[0][:2], None, frames[0][2])
        pose, poses = identity(3), []
        for p, nr, v in frames[1:]:
            sdata, pose, widx = sharded_fusion_step(sdata, p, nr, None, v, pose, K, mesh=fusion_mesh, height=H,
                                                    width=W, cfg=FusionConfig(localize_stride=2))
            poses.append(np.asarray(pose.matrix()))
        out[name] = dict(data=np.asarray(sdata), poses=np.stack(poses), widx=np.asarray(widx))

    fmap, met = run_fusion_sequence_pipelined(list(inputs["small_depths"]), K, mesh=make_pipeline_mesh(devs[:2]),
                                              map_capacity=2 * H * W, cfg=FusionConfig(localize_stride=2))
    out["pipeline"] = dict(poses=np.stack(met.poses), iterations=list(met.icp_iterations))

    wsrc, wdst, wnodes = entry._warp_problem(n, rng)
    graph = build_deformation_graph(jnp.asarray(wsrc), jnp.asarray(wnodes), k_anchors=4, k_arcs=4)
    tf, _, _ = sharded_estimate_warp_field(graph, jnp.asarray(wsrc), jnp.asarray(wdst), None,
                                           jnp.ones((len(wsrc),), jnp.float32), mesh=line_mesh, point_weight=1.0,
                                           plane_weight=0.0, max_gn_iterations=2, max_cg_iterations=20)
    out["warp"] = _tf(tf)
    return out


@pytest.fixture(scope="module")
def world():
    return 2


@pytest.fixture(scope="module")
def both(world, tmp_path_factory):
    """``(JAX's parts, each rank's parts)``: the ranks start first and JAX
    runs while they work."""
    inputs = _inputs()
    ranks = Ranks("dryrun", world, tmp_path_factory.mktemp(f"dryrun{world}"), inputs)
    return _jax_parts(world, inputs), ranks.results()


@pytest.mark.parametrize("part", ["tournament", "ring"])
def test_icp_parts_match_jax(both, part):
    jout, res = both
    for rank, r in enumerate(res):
        for key in ("linear", "translation"):
            np.testing.assert_allclose(r[part][key], jout[part][key], rtol=0, atol=1e-5,
                                       err_msg=f"rank {rank} {key}")
        assert r[part]["iterations"] == jout[part]["iterations"]


def test_ba_part_matches_jax(both):
    jout, res = both
    lmks = np.concatenate([r["ba"]["landmarks"] for r in res])
    np.testing.assert_allclose(lmks, jout["ba"]["landmarks"], rtol=0, atol=1e-4)
    for r in res:
        for key in ("linear", "translation"):
            np.testing.assert_allclose(r["ba"][key], jout["ba"][key], rtol=0, atol=1e-4)
    assert np.isfinite(res[0]["ba"]["residual"])


@pytest.mark.parametrize("name", sorted(DRYRUN_FUSION))
def test_fusion_parts_match_jax(both, name):
    jout, res = both
    np.testing.assert_allclose(res[0][name]["poses"], jout[name]["poses"], rtol=0, atol=1e-5)
    data = np.concatenate([r[name]["data"] for r in res])
    assert data.shape == jout[name]["data"].shape == (DRYRUN_FUSION[name][1] * H * W, 16)


def test_pipeline_part_matches_scanned_driver_and_jax(both):
    jout, res = both
    assert all("pipeline" not in r for r in res[2:])  # ranks past 1 idle, as JAX's devices past 2
    for r in res[:2]:
        p, s = r["pipeline"], r["scanned"]
        assert np.array_equal(p["poses"], s["poses"])
        assert p["iterations"] == s["iterations"]
        assert np.array_equal(p["data"], s["data"])
        np.testing.assert_allclose(p["poses"], jout["pipeline"]["poses"], rtol=0, atol=1e-5)
        assert p["iterations"] == jout["pipeline"]["iterations"]


def test_warp_part_matches_jax(both):
    jout, res = both
    for r in res:
        for key in ("linear", "translation"):
            np.testing.assert_allclose(r["warp"][key], jout["warp"][key], rtol=0, atol=1e-4)


# Replicated outputs by part: the fusion runs' poses and winner images, the
# pipeline's results on the two ranks that run it.
REPLICATED = {"tournament": ("linear", "translation", "iterations"), "ring": ("linear", "translation", "iterations"),
              "ba": ("linear", "translation", "residual"), "warp": ("linear", "translation", "cg_iterations"),
              "big": ("poses", "widx"), "small": ("poses", "widx"), "pipeline": ("poses", "iterations", "data")}


def test_replicated_outputs_are_identical_across_ranks(both, world):
    _, res = both
    for part, keys in REPLICATED.items():
        holders = [r for r in res if part in r]
        assert len(holders) == (2 if part == "pipeline" else world), part
        for r in holders[1:]:
            for key in keys:
                assert np.array_equal(np.asarray(r[part][key]), np.asarray(holders[0][part][key])), (part, key)


@pytest.mark.usefixtures("one_torch_thread")
def test_dryrun_world_of_one_at_real_shapes():
    """The whole entry at its shapes (640×480 and 320×240 fusion, the
    1,228,800-slot pool) in a world of one over gloo, which it ends."""
    import torch.distributed as dist

    assert entry.dryrun_multichip(1, device="cpu") is None
    assert not dist.is_initialized()


def test_dryrun_needs_one_process_per_rank():
    with pytest.raises(ValueError, match="one process per rank"):
        entry.dryrun_multichip(2, device="cpu")
