"""The port's sharded ICP and ring NN (``cilantro_tpu_torch/parallel/
sharded.py``) on a gloo group of 4 subprocess ranks, against the JAX
package's on meshes of the same shapes over the conftest's virtual CPU
devices.

The inputs are ``tests/test_sharded_icp.py``'s (n = 4096, a 0.05 rad turn
and a 2.5 cm shift), at the JAX tests' ICP settings with the function's
default ``convergence_tol`` of 1e-5: at the tests' 1e-7 the last updates
are float32 noise (both packages stop anywhere between 13 and 23
iterations depending on the mesh), so the count would say nothing.
Tolerances: each transform within 1e-5 of JAX's on the same mesh shape
(JAX's own mesh sweep holds 1e-5) with the same iteration count;
``ring_nn1``'s distances within 1e-6 of ‖q‖² + ‖k‖² (see its test) and
payloads equal except at near-ties, and bit for bit the port's one-device
search; every replicated output bit-identical across ranks."""

import datetime

import jax
import numpy as np
import pytest
import torch

from cilantro_tpu.parallel import make_mesh as jmake_mesh
from cilantro_tpu.parallel import ring_nn1 as jring_nn1
from cilantro_tpu.parallel import shard_cloud_arrays as jshard
from cilantro_tpu.parallel import sharded_combined_icp as jicp
from cilantro_tpu.parallel import sharded_combined_icp_ring as jicp_ring
from torch_parallel_ranks import Ranks
from torch_parallel_worker import ICP_KW, ICP_MESHES, icp_case, ring_case

WORLD = 4
DESYNC_TIMEOUT = 5.0


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4-rank group and a 2-rank group that desynchronises, started
    together; the JAX side runs while they work."""
    return {
        "icp": Ranks("icp", WORLD, tmp_path_factory.mktemp("icp"), {}),
        "desync": Ranks("desync", 2, tmp_path_factory.mktemp("desync"),
                        {"mesh_timeout": np.float32(DESYNC_TIMEOUT)}, wait_timeout=60.0),
    }


def _jax_tf(tf, it):
    return np.asarray(tf.linear), np.asarray(tf.translation), int(it)


def _check(rec, jlin, jtr, jit, label):
    np.testing.assert_allclose(rec["linear"], jlin, rtol=0, atol=1e-5, err_msg=label)
    np.testing.assert_allclose(rec["translation"], jtr, rtol=0, atol=1e-5, err_msg=label)
    assert rec["iterations"] == jit, label


@pytest.mark.parametrize("shape", ICP_MESHES, ids=[f"{p}x{q}" for p, q in ICP_MESHES])
def test_tournament_matches_jax(ranks, shape):
    p, q = shape
    pts, dst, nrm, r, t = icp_case()
    ones = np.ones(len(pts), bool)
    mesh = jmake_mesh(p, q, devices=jax.devices()[: p * q])
    jlin, jtr, jit = _jax_tf(*jicp(*jshard(mesh, "points", pts, ones), *jshard(mesh, "map", dst, nrm, ones),
                                   mesh=mesh, **ICP_KW))
    for rank, res in enumerate(ranks["icp"].results()):
        _check(res[f"tournament_{p}x{q}"], jlin, jtr, jit, f"rank {rank}, mesh {p}x{q}")
    # And the registration is the true motion.
    assert np.abs(jlin - r).max() < 1e-4 and np.abs(jtr - t).max() < 1e-4


def test_ring_matches_jax(ranks):
    pts, dst, nrm, _, _ = icp_case()
    ones = np.ones(len(pts), bool)
    mesh = jmake_mesh(WORLD, 1, devices=jax.devices()[:WORLD])
    jlin, jtr, jit = _jax_tf(*jicp_ring(*jshard(mesh, "points", pts, ones, dst, nrm, ones), mesh=mesh,
                                        **ICP_KW))
    for rank, res in enumerate(ranks["icp"].results()):
        _check(res["ring"], jlin, jtr, jit, f"rank {rank}")


def test_ring_nn1_matches_jax(ranks):
    """Both packages sum ‖q‖² + ‖k‖² − 2q·k in float32, in other orders:
    the distances (~0.01 between points of norm ~2) agree within 1e-6 of
    that sum's scale, ‖q‖² + ‖k‖², not of the distance (measured up to
    2.9e-6 absolute). The port's ring equals its own one-device search
    (``nn1_fused``, the same per-pair sums) bit for bit."""
    from cilantro_tpu_torch.neighbors.fused_nn import nn1_fused

    q, keys, payload = ring_case()
    mesh = jmake_mesh(WORLD, 1, devices=jax.devices()[:WORLD])
    qs, qv = jshard(mesh, "points", q, np.ones(len(q), bool))
    ks, ps, kv = jshard(mesh, "points", keys, payload, np.ones(len(keys), bool))
    jd, jp = (np.asarray(a) for a in jring_nn1(qs, qv, ks, ps, kv, mesh=mesh))
    res = ranks["icp"].results()
    d = np.concatenate([r["ring_nn1"]["dist"] for r in res])
    pay = np.concatenate([r["ring_nn1"]["payload"] for r in res])
    od, oi = nn1_fused(torch.as_tensor(q), torch.as_tensor(keys))
    assert np.array_equal(d, od.numpy())
    assert np.array_equal(pay, payload[oi.numpy()])
    scale = np.sum(q**2, axis=1) + np.sum(jp[:, :3] ** 2, axis=1)
    assert np.all(np.abs(d - jd) <= 1e-6 * scale)
    differ = np.any(pay != jp, axis=1)
    # A differing payload is a near-tie: its key is as near as JAX's.
    alt = np.sum((pay[differ, :3].astype(np.float64) - q[differ]) ** 2, axis=1)
    ref = np.sum((jp[differ, :3].astype(np.float64) - q[differ]) ** 2, axis=1)
    assert np.all(np.abs(alt - ref) <= 1e-6 * scale[differ])
    assert differ.sum() <= 2


def test_replicated_outputs_are_identical_across_ranks(ranks):
    res = ranks["icp"].results()
    for key in [f"tournament_{p}x{q}" for p, q in ICP_MESHES] + ["ring"]:
        for other in res[1:]:
            assert np.array_equal(other[key]["linear"], res[0][key]["linear"]), key
            assert np.array_equal(other[key]["translation"], res[0][key]["translation"]), key
            assert other[key]["iterations"] == res[0][key]["iterations"], key


def test_desynchronised_group_fails_within_its_timeout(ranks):
    """Rank 0 stops after 2 iterations, rank 1 runs on: rank 1's next
    collective fails, within the mesh groups' 5 s timeout (not the
    suite's), and both processes end."""
    launch = ranks["desync"]
    first, second = launch.results()
    assert first["raised"] is None
    assert second["raised"] is not None
    assert second["seconds"] < DESYNC_TIMEOUT + 10.0, second
    # Both ranks were done within a minute of their start (the suite's
    # own limit is far longer).
    assert max(first["ended_at"], second["ended_at"]) - launch.started_at < 60.0


@pytest.fixture
def world_of_one():
    """The port's make_mesh makes a gloo world of one in this process; it
    is destroyed at teardown."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    yield
    dist.destroy_process_group()


def test_single_process_mesh_runs_the_tournament(world_of_one):
    """With no process group, ``make_mesh`` makes a world of one (gloo for
    the CPU) and the tournament runs as JAX's 1×1 mesh does."""
    from cilantro_tpu_torch.parallel import make_mesh, process_info, shard_cloud_arrays, sharded_combined_icp

    pts, dst, nrm, _, _ = icp_case(n=1024)
    ones = np.ones(len(pts), bool)
    kw = dict(ICP_KW, convergence_tol=1e-5)
    mesh = make_mesh(device="cpu", timeout=datetime.timedelta(seconds=30))
    assert mesh.mesh_dim_names == ("points", "map") and mesh.size() == 1
    assert process_info()[:2] == (0, 1)
    tf, it = sharded_combined_icp(*shard_cloud_arrays(mesh, "points", pts, ones),
                                  *shard_cloud_arrays(mesh, "map", dst, nrm, ones), mesh=mesh, **kw)
    jmesh = jmake_mesh(1, 1, devices=jax.devices()[:1])
    jlin, jtr, jit = _jax_tf(*jicp(*jshard(jmesh, "points", pts, ones), *jshard(jmesh, "map", dst, nrm, ones),
                                   mesh=jmesh, **kw))
    assert tf.linear.device == torch.device("cpu")
    _check({"linear": tf.linear.numpy(), "translation": tf.translation.numpy(), "iterations": int(it)},
           jlin, jtr, jit, "1x1")
