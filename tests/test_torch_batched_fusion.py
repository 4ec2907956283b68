"""The port's multi-stream fusion (``cilantro_tpu_torch/slam/batched_fusion.py``
and the batched z-buffer of ``core/rgbd.py``) against the JAX package on
the CPU.

Both packages start from the same numpy frames and pools. Tolerances:
index maps exactly (the same key over the same camera-frame points, with
``idx_bits``, ``z_max`` and the 2^20 groups taken over all streams);
pools and packed targets 1e-5 (float32 blends of the same rows, summed in
another order), as ``tests/test_torch_fusion.py`` holds single steps;
poses 1e-4 (the pool driver's bound). Over a sequence a 1e-7 pose
difference flips single z-buffer winners, so sequence pools are held as
JAX holds its batched pools against its single-stream ones
(``tests/test_batched_fusion.py``): occupancy agreement above 0.999 and
rows within 2e-3 above 0.995.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilantro_tpu.core import CameraIntrinsics as JK
from cilantro_tpu.core import depth_to_points_normals as j_frame
from cilantro_tpu.core.rgbd import _zbuffer_winner_batched as j_zbuffer_batched
from cilantro_tpu.core.transforms import Transform as JTransform
from cilantro_tpu.core.transforms import identity as j_identity
from cilantro_tpu.slam import batched_fusion as jbf
from cilantro_tpu.slam import fusion as jf
from cilantro_tpu_torch import native
from cilantro_tpu_torch.core import coalesced, transforms
from cilantro_tpu_torch.core.rgbd import CameraIntrinsics as TK
from cilantro_tpu_torch.core.rgbd import _zbuffer_winner_batched as t_zbuffer_batched
from cilantro_tpu_torch.core.transforms import Transform as TTransform
from cilantro_tpu_torch.core.transforms import identity as t_identity
from cilantro_tpu_torch.slam import batched_fusion as tbf
from cilantro_tpu_torch.slam import driver as tdrv
from cilantro_tpu_torch.slam import fusion as tf_

H, W = 48, 64
CAP = int(1.4 * H * W)
FRAMES = 4
ARGS = (100.0, 100.0, 31.5, 23.5)
JKS, TKS = JK.make(*ARGS), TK.make(*ARGS)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def sequences():
    """Three streams of 4 synthetic frames (seeds 0-2)."""
    return [tdrv.synthetic_sequence(FRAMES, H, W, TKS, seed=s)[0] for s in range(3)]


def seeded_pools(seqs):
    """Each stream's pool seeded by JAX from its frame 0, stacked, and
    each stream's frame 1 back-projected by JAX: ``(pools, points,
    normals, valid)`` as numpy."""
    pools, frames = [], []
    for d in seqs:
        p0, n0, v0 = j_frame(jnp.asarray(d[0]), JKS)
        pools.append(np.asarray(jf.init_map_from_frame(CAP, p0, n0, None, v0).data))
        frames.append([np.asarray(a) for a in j_frame(jnp.asarray(d[1]), JKS)])
    return (np.stack(pools),) + tuple(np.stack([f[i] for f in frames]) for i in range(3))


def stream_poses(bsz):
    """A different small motion for each stream."""
    lin, tr = [], []
    for b in range(bsz):
        a = 0.006 + 0.003 * b
        lin.append([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
        tr.append([0.002 * (b + 1), -0.001, 0.003 - 0.001 * b])
    lin, tr = np.asarray(lin, np.float32), np.asarray(tr, np.float32)
    return JTransform(jnp.asarray(lin), jnp.asarray(tr)), TTransform(t(lin), t(tr))


def zbuffer_case(name):
    """``(points (B, N, 3), valid (B, N))`` in front of the 48×64 camera."""
    rng = np.random.default_rng(7)
    bsz, n = {"one": (1, 3000), "three": (3, 3000), "depth_ranges": (3, 3000),
              "groups_cross_streams": (2, 600_000)}[name]
    z = rng.uniform(1.0, 3.0, (bsz, n))
    if name == "depth_ranges":  # stream b between 1 and 3·(1 + 2b) m: z_max is stream 2's
        z *= (1.0 + 2.0 * np.arange(bsz))[:, None]
    x = (rng.uniform(-2, W + 1, (bsz, n)) - ARGS[2]) * z / ARGS[0]
    y = (rng.uniform(-2, H + 1, (bsz, n)) - ARGS[3]) * z / ARGS[1]
    pts = np.stack([x, y, z], -1).astype(np.float32)
    return pts, rng.random((bsz, n)) < 0.9


@pytest.mark.parametrize("case", ["one", "three", "depth_ranges", "groups_cross_streams"])
def test_zbuffer_winner_batched_matches_jax(case):
    pts, valid = zbuffer_case(case)
    ji, jd = j_zbuffer_batched(jnp.asarray(pts), jnp.asarray(valid), JKS, H, W)
    ti, td = t_zbuffer_batched(t(pts), t(valid), TKS, H, W)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert (ti >= 0).any()
    if case == "groups_cross_streams":  # the first 2^20 rows end inside stream 1
        rows = ti[1][ti[1] >= 0] + pts.shape[1]
        assert (rows < 2**20).any() and (rows >= 2**20).any()
    if case == "depth_ranges":  # one z_max for all streams: the near stream's keys are coarse
        assert (ti[0] >= 0).sum() > 0.5 * H * W


@pytest.mark.parametrize("bsz", [1, 3])
def test_batched_integrate_matches_jax(sequences, bsz):
    pools, pts, nrm, valid = seeded_pools(sequences[:bsz])
    jpose, tpose = stream_poses(bsz)
    jdata, jimap, jpacked = jbf.batched_integrate(
        jnp.asarray(pools), jnp.asarray(pts), jnp.asarray(nrm), None, jnp.asarray(valid), jpose, JKS,
        height=H, width=W, cfg=jf.FusionConfig(),
    )
    tdata, timap, tpacked = tbf.batched_integrate(
        t(pools), t(pts), t(nrm), None, t(valid), tpose, TKS, height=H, width=W, cfg=tf_.FusionConfig(),
    )
    np.testing.assert_array_equal(timap.numpy(), np.asarray(jimap))
    jdata = np.asarray(jdata)
    np.testing.assert_array_equal(tdata[..., 10].numpy() > 0.5, jdata[..., 10] > 0.5)
    np.testing.assert_allclose(tdata.numpy(), jdata, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tpacked.numpy(), np.asarray(jpacked), rtol=0, atol=1e-5)
    assert not torch.equal(tdata, t(pools))  # rows were fused


def test_batched_seed_localize_target_matches_jax(sequences):
    pools = seeded_pools(sequences)[0]
    jpose, tpose = stream_poses(3)
    jimap, jpacked = jbf.batched_seed_localize_target(jnp.asarray(pools), jpose, JKS, H, W)
    timap, tpacked = tbf.batched_seed_localize_target(t(pools), tpose, TKS, H, W)
    np.testing.assert_array_equal(timap.numpy(), np.asarray(jimap))
    np.testing.assert_allclose(tpacked.numpy(), np.asarray(jpacked), rtol=0, atol=1e-5)


def assert_sequence_pools_close(t_data, j_data):
    """JAX's batched-vs-single pool bounds (tests/test_batched_fusion.py)."""
    for tb, jb in zip(np.asarray(t_data), np.asarray(j_data)):
        vt, vj = tb[:, 10] > 0.5, jb[:, 10] > 0.5
        assert (vt == vj).mean() > 0.999
        both = vt & vj
        close = np.isclose(tb[both], np.where(jb[both] > 1e29, tb[both], jb[both]), atol=2e-3).all(axis=1)
        assert close.mean() > 0.995


def test_batched_fusion_step_matches_jax(sequences):
    """Three frames of two streams stepped by each package's
    ``batched_fusion_step`` (stride-2 localize), from the same seeded
    pools: poses, ICP iterations and pools."""
    seqs = sequences[:2]
    pools = seeded_pools(seqs)[0]
    jcfg, tcfg = jf.FusionConfig(localize_stride=2), tf_.FusionConfig(localize_stride=2)
    jdata, jposes = jnp.asarray(pools), j_identity(3, batch_shape=(2,))
    tdata, tposes = t(pools), t_identity(3, batch_shape=(2,), device="cpu")
    _, jpacked = jbf.batched_seed_localize_target(jdata, jposes, JKS, H, W)
    _, tpacked = tbf.batched_seed_localize_target(tdata, tposes, TKS, H, W)
    for f in range(1, FRAMES):
        frames = [[np.asarray(a) for a in j_frame(jnp.asarray(d[f]), JKS)] for d in seqs]
        p, n, v = (np.stack([fr[i] for fr in frames]) for i in range(3))
        jdata, jposes, jres, _, jpacked = jbf.batched_fusion_step(
            jdata, jnp.asarray(p), jnp.asarray(n), None, jnp.asarray(v), jposes, JKS, jpacked,
            height=H, width=W, cfg=jcfg,
        )
        tdata, tposes, tres, timap, tpacked = tbf.batched_fusion_step(
            tdata, t(p), t(n), None, t(v), tposes, TKS, tpacked, height=H, width=W, cfg=tcfg,
        )
        np.testing.assert_allclose(tposes.matrix().numpy(), np.asarray(jposes.matrix()), rtol=0, atol=1e-4)
        np.testing.assert_array_equal(tres.iterations.numpy(), np.asarray(jres.iterations))
        assert timap.shape == (2, H, W) and tres.transform.batch_shape == (2,)
    assert_sequence_pools_close(tdata, jdata)


def test_run_batched_fusion_sequences_matches_jax_and_single_streams(sequences):
    """A 4-frame, B = 2 run of each package's driver (the JAX bench row's
    settings: pool of 1.4·H·W rows, stride-2 localize); each stream of the
    port's run against the port's single-stream scanned driver."""
    seqs = sequences[:2]
    stacks = np.stack([np.stack(d) for d in seqs])
    jcfg, tcfg = jf.FusionConfig(localize_stride=2), tf_.FusionConfig(localize_stride=2)
    jdata, jm = jbf.run_batched_fusion_sequences(stacks, JKS, map_capacity=CAP, cfg=jcfg)
    stats = {}
    native.reset_launch_counts()
    tdata, tm = tbf.run_batched_fusion_sequences(stacks, TKS, map_capacity=CAP, cfg=tcfg, device="cpu",
                                                 stats=stats)
    # CPU tensors take the plain versions: no kernel launched.
    assert stats["launches_per_step"] == dict.fromkeys(native.launch_counts, 0)
    assert stats["device_seconds_per_step"] is None
    assert (tm.streams, tm.frames, tm.poses.shape) == (2, FRAMES, (2, FRAMES, 4, 4))
    assert tm.aggregate_fps == pytest.approx(2 / tm.seconds_per_step)
    np.testing.assert_allclose(tm.poses, np.asarray(jm.poses), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tm.num_map_points, np.asarray(jm.num_map_points))
    assert_sequence_pools_close(tdata, jdata)
    for b, d in enumerate(seqs):
        fmap, single = tdrv.run_fusion_sequence_scanned(d, TKS, map_capacity=CAP, cfg=tcfg, device="cpu")
        np.testing.assert_allclose(tm.poses[b], np.stack(single.poses), rtol=0, atol=1e-4)
        assert list(stats["icp_iterations"][b]) == single.icp_iterations
        assert tm.num_map_points[b] == single.num_map_points


def test_batched_update_modes_agree(sequences):
    """``row_scatter`` and ``inverse_gather`` give the same pools and poses,
    bit for bit (JAX's tests/test_batched_fusion.py requires it of JAX)."""
    stacks = np.stack([np.stack(d[:3]) for d in sequences[:2]])
    out = {}
    for mode in ("row_scatter", "inverse_gather"):
        cfg = dataclasses.replace(tf_.FusionConfig(), update_mode=mode)
        out[mode] = tbf.run_batched_fusion_sequences(stacks, TKS, map_capacity=CAP, cfg=cfg, device="cpu")
    (d_r, m_r), (d_i, m_i) = out["row_scatter"], out["inverse_gather"]
    assert torch.equal(d_r.view(torch.int32), d_i.view(torch.int32))
    np.testing.assert_array_equal(m_r.poses, m_i.poses)


def test_stack_and_unstack_maps():
    maps = [tf_.empty_map(8, device="cpu") for _ in range(3)]
    data = tbf.stack_maps(maps)
    assert data.shape == (3, 8, 16)
    back = tbf.unstack_maps(data)
    assert len(back) == 3 and all(torch.equal(m.data, b.data) for m, b in zip(maps, back))
