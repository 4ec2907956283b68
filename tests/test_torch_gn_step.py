"""The plain version of the rigid 3-D Gauss-Newton step's launches
(``registration/gn_step.py``, the arithmetic of ``csrc/gn_kernels.cu``) on
the CPU: against the port's einsum path and the JAX package's estimator,
its summation order against a literal model of the kernels' threads, and
the route counters.

The einsum path and JAX sum float32 rows in float32; the plain version
sums in float64 in the kernels' order. Both sides' estimates agree within
1e-5, the bound the port's estimator tests hold against JAX.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from torch.profiler import ProfilerActivity, profile

from cilantro_tpu.registration import transform_estimation as jte
from cilantro_tpu_torch.registration import gn_step
from cilantro_tpu_torch.registration import transform_estimation as tte

TOL = 1e-5


def _rows(n, seed=1):
    """A surface patch 1.5 m away and its noisy copy, unit normals, point
    weights in [0, 1) and 0/1 plane weights (a fifth dropped)."""
    rng = np.random.default_rng(seed)
    src = (rng.uniform(-0.3, 0.3, (n, 3)) + [0.2, -0.1, 1.5]).astype(np.float32)
    dst = (src + rng.normal(0, 0.01, src.shape)).astype(np.float32)
    nd, ns = (rng.normal(0, 1, (2, n, 3)))
    nd = (nd / np.linalg.norm(nd, axis=1, keepdims=True)).astype(np.float32)
    ns = (ns / np.linalg.norm(ns, axis=1, keepdims=True)).astype(np.float32)
    w1 = rng.uniform(0, 1, n).astype(np.float32)
    w2 = (rng.random(n) < 0.8).astype(np.float32)
    return src, dst, ns, nd, w1, w2


def _case(metric, weights, n):
    src, dst, ns, nd, w1, w2 = _rows(n)
    wpp = {"plane": 0 * w1, "point_and_plane": 0.3 * w1, "none": 0 * w1}[weights]
    wpl = 0 * w2 if weights == "none" else w2
    return src, dst, (ns if metric == "symmetric" else None), nd, wpp.astype(np.float32), wpl


# 1,000 rows: 4 blocks, one row a thread at most; 70,001: 256 blocks, two
# rows for some threads, the last block ragged.
CASES = [(metric, weights, n, its) for metric in ("combined", "symmetric")
         for weights in ("plane", "point_and_plane", "none") for n in (1_000, 70_001) for its in (1, 3)]


def _plain(case, its):
    src, dst, ns, nd, wpp, wpl = (None if a is None else torch.from_numpy(a) for a in case)
    return gn_step.gauss_newton_3d(src, dst, ns, nd, wpp, wpl, its, 1e-9)


def _assert_close(got, want_linear, want_translation):
    np.testing.assert_allclose(got.linear.numpy(), np.asarray(want_linear), rtol=0, atol=TOL)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want_translation), rtol=0, atol=TOL)


@pytest.mark.parametrize("metric, weights, n, its", CASES)
def test_plain_step_matches_the_einsum_path(metric, weights, n, its):
    case = _case(metric, weights, n)
    got, ok = _plain(case, its)
    src, dst, ns, nd, wpp, wpl = (None if a is None else torch.from_numpy(a) for a in case)
    kw = dict(point_weights=wpp, plane_weights=wpl, max_iterations=its, convergence_tol=1e-9)
    if ns is None:
        want, wok = tte.estimate_rigid_combined_metric(src, dst, nd, **kw)
    else:
        want, wok = tte.estimate_rigid_symmetric_metric(src, dst, ns, nd, **kw)
    _assert_close(got, want.linear, want.translation)
    assert bool(ok) == bool(wok) == (weights != "none")


@pytest.mark.parametrize("metric, weights, n, its", CASES)
def test_plain_step_matches_jax(metric, weights, n, its):
    case = _case(metric, weights, n)
    got, ok = _plain(case, its)
    src, dst, ns, nd, wpp, wpl = (None if a is None else jnp.asarray(a) for a in case)
    kw = dict(point_weights=wpp, plane_weights=wpl, max_iterations=its, convergence_tol=1e-9)
    if ns is None:
        want, wok = jte.estimate_rigid_combined_metric(src, dst, nd, **kw)
    else:
        want, wok = jte.estimate_rigid_symmetric_metric(src, dst, ns, nd, **kw)
    _assert_close(got, want.linear, want.translation)
    assert bool(ok) == bool(wok)


def _thread_model(c: np.ndarray, blocks: int) -> np.ndarray:
    """One value a row summed as the kernels' threads do, written out: each
    thread's rows in order, the shuffle-down halving in each warp, the
    halving over the warps; the block partials ``(blocks,)``."""
    threads = gn_step.THREADS
    span = blocks * threads
    acc = np.zeros(span)
    for g in range(span):
        for i in range(g, len(c), span):
            acc[g] = acc[g] + c[i]
    out = np.zeros(blocks)
    for b in range(blocks):
        lanes = acc[b * threads:(b + 1) * threads].reshape(-1, 32).copy()
        for off in (16, 8, 4, 2, 1):
            lanes[:, :off] = lanes[:, :off] + lanes[:, off:2 * off]
        warps = lanes[:, 0].copy()
        for h in (4, 2, 1):
            warps[:h] = warps[:h] + warps[h:2 * h]
        out[b] = warps[0]
    return out


@pytest.mark.parametrize("n", [1, 255, 1_000, 70_001])
def test_pass_partials_follow_the_kernels_order(n):
    c = np.random.default_rng(n).normal(0, 1, n) * np.exp(np.random.default_rng(n + 1).normal(0, 8, n))
    blocks = gn_step.blocks_for(n)
    got = gn_step._pass_partials(torch.from_numpy(c)[None], blocks)[:, 0].numpy()
    want = _thread_model(c, blocks)
    assert got.view(np.int64).tolist() == want.view(np.int64).tolist()
    assert gn_step.blocks_for(n) == min(max(-(-n // 256), 1), 256)


def _route_counts(run):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    names = [e.name for e in prof.events()]
    return (sum(n == "cilantro.count.gn_step_route_fused=1" for n in names),
            sum(n == "cilantro.count.gn_step_route_plain=1" for n in names))


@pytest.mark.parametrize("metric", ["combined", "symmetric"])
def test_cpu_estimates_count_the_plain_route(metric):
    src, dst, ns, nd, w1, w2 = (torch.from_numpy(a) for a in _rows(500))
    kw = dict(point_weights=0.3 * w1, plane_weights=w2, max_iterations=3, convergence_tol=0.0)
    if metric == "combined":
        fused, plain = _route_counts(lambda: tte.estimate_rigid_combined_metric(src, dst, nd, **kw))
    else:
        fused, plain = _route_counts(lambda: tte.estimate_rigid_symmetric_metric(src, dst, ns, nd, **kw))
    assert (fused, plain) == (0, 3)


def _estimators(ns):
    """The port's and JAX's estimator of the case's metric."""
    if ns is None:
        return (lambda s, d, ns_, nd, **kw: tte.estimate_rigid_combined_metric(s, d, nd, **kw),
                lambda s, d, ns_, nd, **kw: jte.estimate_rigid_combined_metric(s, d, nd, **kw))
    return tte.estimate_rigid_symmetric_metric, jte.estimate_rigid_symmetric_metric


@pytest.mark.parametrize("metric, weights", [(m, w) for m in ("combined", "symmetric")
                                             for w in ("plane", "point_and_plane", "none")])
def test_no_iteration_is_the_uncentred_identity(metric, weights):
    """No GN iteration: the estimators return the identity moved by the
    means' difference (the einsum path, which the card takes too), as JAX
    does; the step itself wants at least one iteration."""
    case = _case(metric, weights, 1_000)
    port, jax_ = _estimators(case[2])
    tt = [None if a is None else torch.from_numpy(a) for a in case]
    kw = dict(max_iterations=0, convergence_tol=1e-9)
    got, ok = port(*tt[:4], point_weights=tt[4], plane_weights=tt[5], **kw)
    jj = [None if a is None else jnp.asarray(a) for a in case]
    want, wok = jax_(*jj[:4], point_weights=jj[4], plane_weights=jj[5], **kw)
    _assert_close(got, want.linear, want.translation)
    np.testing.assert_array_equal(got.linear.numpy(), np.eye(3, dtype=np.float32))
    assert bool(ok) == bool(wok)
    with pytest.raises(ValueError):
        gn_step.gauss_newton_3d(*tt, 0, 1e-9)


@pytest.mark.parametrize("metric", ["combined", "symmetric"])
@pytest.mark.parametrize("layout", ["strided_points", "scalar_weights", "row_strided"])
def test_step_rows_fit_any_layout(metric, layout):
    """Points without unit stride along their last axis are copied, scalar
    weights broadcast and rows any distance apart read in place: the step
    gives the bits of the same values laid out plainly."""
    src, dst, ns, nd, wpp, wpl = (None if a is None else torch.from_numpy(a)
                                  for a in _case(metric, "point_and_plane", 1_000))
    if layout == "scalar_weights":
        wpp, wpl = torch.tensor(0.25), torch.tensor(1.0)
        plain = (src, dst, ns, nd, torch.full((1_000,), 0.25), torch.ones(1_000))
        laid = (src, dst, ns, nd, wpp, wpl)
    elif layout == "strided_points":
        plain = (src, dst, ns, nd, wpp, wpl)
        laid = tuple(None if t is None else t.T.contiguous().T if t.dim() == 2 else t for t in plain)
        assert laid[0].stride(-1) != 1
    else:
        plain = (src, dst, ns, nd, wpp, wpl)
        laid = tuple(None if t is None else torch.cat([t, t], -1)[..., :3] if t.dim() == 2 else t for t in plain)
        assert laid[0].stride(0) == 6
    rows = gn_step.step_rows(*laid)
    assert all(t is None or t.dim() == 1 or t.stride(-1) == 1 for t in rows)
    assert all(t.shape == (1_000,) for t in rows[4:])
    a, aok = gn_step.gauss_newton_3d(*laid, 2, 0.0)
    b, bok = gn_step.gauss_newton_3d(*plain, 2, 0.0)
    assert torch.equal(a.linear, b.linear) and torch.equal(a.translation, b.translation)
    assert bool(aok) == bool(bok)


class _OnCard:
    """A tensor's shape and type, said to lie on a CUDA device: what the
    route reads."""

    def __init__(self, t, is_cuda=True):
        self.shape, self.dtype, self.is_cuda = t.shape, t.dtype, is_cuda

    def dim(self):
        return len(self.shape)


def test_route_reads_device_dtype_rank_and_d():
    """One problem of 3-D float32 points on the card takes the kernels,
    whatever its layout; the CPU, 2-D points, a batch or another type keep
    the einsum path."""
    p, w = torch.zeros(10, 3), torch.zeros(10)
    assert gn_step.takes(_OnCard(p), _OnCard(p.T.contiguous().T), None, _OnCard(torch.zeros(())))
    assert not gn_step.takes(p, p, p, None, None)
    assert not gn_step.takes(_OnCard(p), _OnCard(p), _OnCard(w, is_cuda=False))
    for src in (p[:, :2], p[None], p.double()):
        assert not gn_step.takes(_OnCard(src), _OnCard(src))
