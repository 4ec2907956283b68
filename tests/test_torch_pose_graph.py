"""The port's pose graph (``cilantro_tpu_torch/slam/pose_graph.py``)
against the JAX package's on the CPU.

Tolerances: ``_log_so3`` and ``pose_error`` within 1e-6 absolute plus
1e-6 relative (a few float32 ulps of values up to π: ``arccos`` and
``θ / sin θ`` round differently in the two libraries). ``optimize_pose_graph``
within 1e-4 rad and m at the converged poses: its numeric Jacobians
(forward differences at ``eps = 1e-5`` in float32) amplify rounding by
1e5, so the GN paths part in the low bits and meet again at the optimum.
The graphs are consistent (measurements from the true poses, fixed poses
at their true values): on an inconsistent graph the residual stays large
and both packages' steps keep a noise floor of ~5e-4 in the update norm,
from the same forward differences."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilantro_tpu.core.transforms import Transform as JTransform
from cilantro_tpu.slam import pose_graph as jpg
from cilantro_tpu_torch.core import segment as seg
from cilantro_tpu_torch.core.transforms import Transform
from cilantro_tpu_torch.slam import pose_graph as tpg
from cilantro_tpu_torch.tools import slam_problems as sp


def _both(linear, translation):
    linear, translation = np.asarray(linear, np.float32), np.asarray(translation, np.float32)
    return (JTransform(jnp.asarray(linear), jnp.asarray(translation)),
            Transform(torch.as_tensor(linear), torch.as_tensor(translation)))


@pytest.mark.parametrize("scale", [0.0, 1e-7, 1e-3, 0.3, 1.5, 3.0])
def test_log_so3_matches_jax(scale):
    rng = np.random.default_rng(1)
    r = np.stack([sp.rand_rot(rng, scale) for _ in range(64)]).astype(np.float32)
    want = np.asarray(jpg._log_so3(jnp.asarray(r)))
    got = tpg._log_so3(torch.as_tensor(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_pose_error_matches_jax():
    rng = np.random.default_rng(2)
    mats = [[sp.rand_rot(rng, 0.5) for _ in range(32)] for _ in range(3)]
    trans = [rng.standard_normal((32, 3)) for _ in range(3)]
    (ji, ti), (jj, tj), (jz, tz) = (_both(m, t) for m, t in zip(mats, trans))
    want = np.asarray(jpg.pose_error(ji, jj, jz))
    got = tpg.pose_error(ti, tj, tz).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_optimize_pose_graph_chain_matches_jax(rng, weighted):
    true, init, ei, ej, z = sp.pose_graph_chain(rng)  # tests/test_slam_backend.py:99's chain
    kw = {}
    if weighted:  # the loop edge trusted 5×, poses 0 and 2 fixed at their true values
        init[2] = true[2].copy()
        w = np.ones(len(ei), np.float32)
        w[-1] = 5.0
        fixed = np.zeros(len(init), bool)
        fixed[[0, 2]] = True
        kw = dict(edge_weights=w, fixed_mask=fixed)
    jp, tp = _both(np.stack([t[:3, :3] for t in init]), np.stack([t[:3, 3] for t in init]))
    jz, tz = _both(np.stack([m[:3, :3] for m in z]), np.stack([m[:3, 3] for m in z]))
    jopt, jdn = jpg.optimize_pose_graph(
        jp, jnp.asarray(ei), jnp.asarray(ej), jz, max_iterations=20,
        **{k: jnp.asarray(v) for k, v in kw.items()},
    )
    topt, tdn = tpg.optimize_pose_graph(
        tp, torch.as_tensor(ei), torch.as_tensor(ej), tz, max_iterations=20,
        **{k: torch.as_tensor(v) for k, v in kw.items()},
    )
    np.testing.assert_allclose(topt.linear.numpy(), np.asarray(jopt.linear), rtol=0, atol=1e-4)
    np.testing.assert_allclose(topt.translation.numpy(), np.asarray(jopt.translation), rtol=0, atol=1e-4)
    assert float(tdn) < 1e-3 and float(jdn) < 1e-3
    if not weighted:  # the JAX test's own bound against the true poses
        for i in range(len(true)):
            err = np.linalg.norm(topt.linear[i].numpy() - true[i][:3, :3]) + np.linalg.norm(
                topt.translation[i].numpy() - true[i][:3, 3])
            assert err < 1e-2


def test_scatter_sum_adds_in_scatter_order():
    """The sorted segment sum gives ``zeros.at[keys].add(values)`` with the
    rows of one key added in their order, as a sequential scatter does."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 7, 50)
    values = torch.as_tensor(rng.standard_normal((50, 6)).astype(np.float32) * 10 ** rng.uniform(-3, 3, (50, 1)).astype(np.float32))
    got = seg.sorted_scatter_sum(values, seg.sorted_scatter_plan(keys, 9, "cpu"), 9)
    want = torch.zeros(9, 6)
    for key, v in zip(keys, values):
        want[key] = want[key] + v
    assert torch.equal(got, want)
