"""The port's single-device Schur bundle adjustment
(``cilantro_tpu_torch/slam/bundle_adjustment.py``) against the JAX
package's on the CPU.

Tolerances: poses, landmarks and the residual within 1e-4 on the
``tests/test_slam_backend.py`` problem (K = 4, L = 64). Both solve the
same GN steps with float32 sums in other orders (the port's segment sums
add each landmark's or camera's rows in observation order; XLA's
einsums contract in its own order), and PCG stops on ``r·r > 1e-10``, so
iteration counts may part once the residual reaches float32 noise; the
poses agree to a few 1e-7 there. The blocks of one GN step agree within
1e-5 relative."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilantro_tpu.core.transforms import Transform as JTransform
from cilantro_tpu.slam import bundle_adjustment as jba
from cilantro_tpu_torch import interop
from cilantro_tpu_torch.slam import bundle_adjustment as tba
from cilantro_tpu_torch.tools import pcg_forms
from cilantro_tpu_torch.tools import slam_problems as sp


@pytest.fixture()
def ba_problem(rng):
    """``tests/test_slam_backend.py``'s problem: 4 cameras see 64
    landmarks, perturbed poses and landmarks; the numpy problem and the
    truth."""
    return sp.small_ba_problem(rng)


def _jax_solve(problem, **kw):
    lin, tr, x0, cam, lmk, obs = problem
    return jba.bundle_adjust(
        JTransform(jnp.asarray(lin), jnp.asarray(tr)), jnp.asarray(x0), jnp.asarray(cam),
        jnp.asarray(lmk), jnp.asarray(obs), **kw,
    )


@pytest.mark.parametrize("iterations", [1, 15])
def test_bundle_adjust_matches_jax(ba_problem, iterations):
    problem, (true_r, true_t) = ba_problem
    jp, jl, jr = _jax_solve(problem, max_iterations=iterations)
    stats = {}
    tp, tl, tr = tba.bundle_adjust(*interop.ba_problem_from_numpy(*problem, device="cpu"),
                                   max_iterations=iterations, device="cpu", stats=stats)
    assert stats["iterations"] == iterations
    np.testing.assert_allclose(tp.linear.numpy(), np.asarray(jp.linear), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tp.translation.numpy(), np.asarray(jp.translation), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(tr), float(jr), rtol=0, atol=1e-4)
    if iterations == 15:  # the JAX test's own bounds
        assert float(tr) < 1e-6
        for i in range(len(true_r)):
            assert np.linalg.norm(tp.linear[i].numpy() - true_r[i]) < 1e-2
            assert np.linalg.norm(tp.translation[i].numpy() - true_t[i]) < 1e-2


def test_one_gn_step_blocks_match_jax(ba_problem):
    """``_ba_blocks``, the PCG solve and the back-substitution of the first
    GN step against JAX's on the same inputs."""
    (lin, tr, x0, cam, lmk, obs), _ = ba_problem
    k, l, o = lin.shape[0], x0.shape[0], cam.shape[0]
    w = np.ones(o, np.float32)
    jposes = JTransform(jnp.asarray(lin), jnp.asarray(tr))
    jout = jba._ba_blocks(jposes, jnp.asarray(x0), jnp.asarray(cam), jnp.asarray(lmk),
                          jnp.asarray(obs), jnp.asarray(w), l)
    tposes, tx0, tcam, tlmk, tobs = interop.ba_problem_from_numpy(lin, tr, x0, cam, lmk, obs, device="cpu")
    seg = tba._Segments.of(tcam, tlmk, k, l)
    tout = tba._ba_blocks(tposes, tx0, tcam, tlmk, tobs, torch.as_tensor(w), seg)
    for name, a, b in zip(("h_cc", "h_cl", "h_ll_inv", "b_l", "g", "resid"), jout, tout):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-5, err_msg=name)
    keep = np.ones(k, np.float32)
    keep[0] = 0.0
    h_cc, h_cl, h_ll_inv, b_l, g, _ = jout
    jdc = jba._pcg_schur(g, h_cc, h_cl, h_ll_inv, jnp.asarray(cam), jnp.asarray(lmk), l,
                         jnp.asarray(keep), 1e-6)
    jdx = jba._back_substitute(jdc, h_cl, h_ll_inv, b_l, jnp.asarray(cam), jnp.asarray(lmk), l)
    h_cc, h_cl, h_ll_inv, b_l, g, _ = tout
    tdc, it = tba._pcg_schur(g, h_cc, h_cl, h_ll_inv, tcam, tlmk, seg, torch.as_tensor(keep), 1e-6)
    tdx = tba._back_substitute(tdc, h_cl, h_ll_inv, b_l, tcam, seg)
    assert 0 < int(it) <= 60
    np.testing.assert_allclose(tdc.numpy(), np.asarray(jdc), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), rtol=0, atol=1e-5)


@pytest.mark.parametrize("chunk", [1, 7])
def test_chunked_pcg_equals_one_chunk(ba_problem, chunk):
    """The PCG's device flag freezes the iterates once JAX's loop condition
    fails, so the module's form (all ``max_cg`` iterations, no host read)
    gives the bits of ``tools/pcg_forms.py``'s, which reads the flag every
    ``chunk`` iterations and ends the loop there."""
    problem, _ = ba_problem
    out = []
    for reads in (lambda: pcg_forms.reads_every(chunk), contextlib.nullcontext):
        with reads():
            stats = {}
            p, lm, r = tba.bundle_adjust(*interop.ba_problem_from_numpy(*problem, device="cpu"),
                                         max_iterations=4, device="cpu", stats=stats)
        out.append((p.linear, p.translation, lm, r, stats["cg_iterations"]))
    (a, b) = out
    assert a[4] == b[4]
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y)


def test_mapping_scale_reduced_residual_falls():
    """The mapping-scale problem cut to K = 64, L = 20,000, O = 60,000: the
    residual falls from the perturbed start toward the noise floor
    (O · 3e-6), as JAX's does on the same problem."""
    problem = sp.mapping_ba_problem(64, 20_000, 60_000)
    tp, tx, tcam, tlmk, tobs = interop.ba_problem_from_numpy(*problem, device="cpu")
    seg = tba._Segments.of(tcam, tlmk, 64, 20_000)
    before = float(tba._ba_blocks(tp, tx, tcam, tlmk, tobs, torch.ones(60_000), seg)[5])
    stats = {}
    _, _, resid = tba.bundle_adjust(tp, tx, tcam, tlmk, tobs, max_iterations=3, max_cg=30,
                                    device="cpu", stats=stats)
    _, _, jresid = _jax_solve(problem, max_iterations=3, max_cg=30)
    assert float(resid) < 0.1 * before, (before, float(resid))
    assert float(resid) < 3.0 * 60_000 / 300_000, float(resid)
    np.testing.assert_allclose(float(resid), float(jresid), rtol=0.05)
