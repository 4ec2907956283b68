"""The port's PCA, pair evaluators, nearest-neighbour graph matrices and MDS
(``cilantro_tpu_torch/core/pca.py``, ``core/pair_evaluators.py``,
``utils/graph.py``, ``utils/mds.py``) against the JAX package on the same
numpy-seeded inputs, on the CPU.

Tolerances: PCA eigenvalues 1e-5 relative and the basis 1e-5 per column up
to its sign (the port's Jacobi ``eigh_sym`` and JAX's ``eigh`` fix signs
differently; both keep det = +1); evaluators and graph matrices exactly
(the same elementwise ops, a max scatter); MDS eigenvalues 1e-4 relative
and pairwise distances of the embedding 1e-4 (the embedding is defined up
to per-axis signs)."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilantro_tpu.core import pair_evaluators as jpe
from cilantro_tpu.core import pca as jpca
from cilantro_tpu.neighbors.api import Neighborhoods as JNb
from cilantro_tpu.utils import graph as jg
from cilantro_tpu_torch import interop
from cilantro_tpu_torch.core import pair_evaluators as tpe
from cilantro_tpu_torch.core import pca as tpca
from cilantro_tpu_torch.utils import graph as tg

# Each package's ``utils.mds`` re-exports the function ``mds`` over the module.
jmds = importlib.import_module("cilantro_tpu.utils.mds")
tmds = importlib.import_module("cilantro_tpu_torch.utils.mds")


def _cloud(seed, n=500, d=3):
    rng = np.random.default_rng(seed)
    scale = np.array([3.0, 1.0, 0.2, 0.5][:d], np.float32)
    rot = np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32)
    return ((rng.standard_normal((n, d)) * scale) @ rot.T + 0.5).astype(np.float32)


def _same_basis(got, want, atol):
    signs = np.sign(np.sum(got * want, axis=-2, keepdims=True))
    np.testing.assert_allclose(got * signs, want, rtol=0, atol=atol)


@pytest.mark.parametrize("d, masked", [(3, False), (3, True), (2, False)])
def test_fit_pca_matches_jax(d, masked):
    pts = _cloud(d, d=d)
    mask = np.random.default_rng(9).random(len(pts)) < 0.7 if masked else None
    jp = jpca.fit_pca(jnp.asarray(pts), None if mask is None else jnp.asarray(mask))
    tp = tpca.fit_pca(torch.as_tensor(pts), None if mask is None else torch.as_tensor(mask))
    np.testing.assert_allclose(tp.eigenvalues.numpy(), np.asarray(jp.eigenvalues), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tp.mean.numpy(), np.asarray(jp.mean), rtol=0, atol=1e-6)
    _same_basis(tp.eigenvectors.numpy(), np.asarray(jp.eigenvectors), 1e-5)
    assert abs(float(torch.linalg.det(tp.eigenvectors)) - 1.0) < 1e-5
    # project / reconstruct round-trips through the full basis; the leading
    # component's coordinate is JAX's up to the column's sign.
    proj = tp.project(torch.as_tensor(pts), d)
    np.testing.assert_allclose(tp.reconstruct(proj).numpy(), pts, rtol=0, atol=1e-5)
    jproj = np.asarray(jp.project(jnp.asarray(pts), 1))
    got = proj[:, :1].numpy()
    np.testing.assert_allclose(got * np.sign(np.sum(got * jproj)), jproj, rtol=0, atol=1e-4)


def test_pca_from_jax_leaves_projects_as_jax():
    pts = _cloud(4)
    jp = jpca.fit_pca(jnp.asarray(pts))
    tp = interop.pca_from_numpy(*(np.asarray(getattr(jp, f.name)) for f in dataclasses.fields(jp)),
                                device="cpu")
    np.testing.assert_allclose(tp.project(torch.as_tensor(pts), 2).numpy(),
                               np.asarray(jp.project(jnp.asarray(pts), 2)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tp.reconstruct(tp.project(torch.as_tensor(pts), 2)).numpy(),
                               np.asarray(jp.reconstruct(jp.project(jnp.asarray(pts), 2))),
                               rtol=0, atol=1e-6)


def _evaluator_inputs(seed=1, m=400):
    rng = np.random.default_rng(seed)
    nrm = rng.standard_normal((60, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    col = rng.random((60, 3)).astype(np.float32)
    i = rng.integers(0, 60, m).astype(np.int32)
    j = rng.integers(0, 60, m).astype(np.int32)
    dist = rng.random(m).astype(np.float32) * 0.1
    return nrm, col, i, j, dist


EVALUATORS = {
    "identity": lambda pe, n, c: pe.identity_weight,
    "unity": lambda pe, n, c: pe.unity_weight,
    "rbf_sq": lambda pe, n, c: pe.rbf_kernel_weight(0.05),
    "rbf": lambda pe, n, c: pe.rbf_kernel_weight(0.05, distances_are_squared=False),
    "points": lambda pe, n, c: pe.points_proximity(0.05),
    "normals": lambda pe, n, c: pe.normals_proximity(n, 0.8),
    "normals_two_sided": lambda pe, n, c: pe.normals_proximity(n, -0.8),
    "colors": lambda pe, n, c: pe.colors_proximity(c, 0.5),
    "points_normals": lambda pe, n, c: pe.points_normals_proximity(n, 0.05, 1.0),
    "points_colors": lambda pe, n, c: pe.points_colors_proximity(c, 0.05, 0.5),
    "normals_colors": lambda pe, n, c: pe.normals_colors_proximity(n, c, -1.0, 0.6),
    "all": lambda pe, n, c: pe.points_normals_colors_proximity(n, c, 0.06, 1.2, 0.7),
}


@pytest.mark.parametrize("name", sorted(EVALUATORS))
def test_pair_evaluators_match_jax(name):
    nrm, col, i, j, dist = _evaluator_inputs()
    jev = EVALUATORS[name](jpe, jnp.asarray(nrm), jnp.asarray(col))
    tev = EVALUATORS[name](tpe, torch.as_tensor(nrm), torch.as_tensor(col))
    want = np.asarray(jev(jnp.asarray(i), jnp.asarray(j), jnp.asarray(dist)))
    got = tev(torch.as_tensor(i), torch.as_tensor(j), torch.as_tensor(dist)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _graph(seed=2, n=80, k=6):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (n, k)).astype(np.int32)
    mask = rng.random((n, k)) < 0.8
    dist = np.where(mask, rng.random((n, k)), 3.0e38).astype(np.float32)
    idx = np.where(mask, idx, 0).astype(np.int32)
    return (JNb(jnp.asarray(idx), jnp.asarray(dist), jnp.asarray(mask)),
            interop.neighborhoods_from_numpy(idx, dist, mask, device="cpu"))


@pytest.mark.parametrize("symmetrize", [True, False])
def test_graph_matrices_match_jax(symmetrize):
    jn, tn = _graph()
    np.testing.assert_array_equal(tg.neighborhood_degrees(tn).numpy(), np.asarray(jg.neighborhood_degrees(jn)))
    np.testing.assert_array_equal(tg.adjacency_dense(tn, symmetrize).numpy(),
                                  np.asarray(jg.adjacency_dense(jn, symmetrize)))
    fn_j, fn_t = (lambda d: jnp.exp(-d / 0.3)), (lambda d: torch.exp(-d / 0.3))
    np.testing.assert_allclose(tg.function_value_dense(tn, fn_t, 0.0, symmetrize).numpy(),
                               np.asarray(jg.function_value_dense(jn, fn_j, 0.0, symmetrize)),
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tg.distance_dense(tn, fill=-1.0).numpy(),
                                  np.asarray(jg.distance_dense(jn, fill=-1.0)))
    for got, want in zip(tg.function_value_sparse(tn, fn_t), jg.function_value_sparse(jn, fn_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("estimate_dim", [False, True])
def test_mds_matches_jax(estimate_dim):
    """JAX's ``mds`` traces ``squared`` (not a static argument), so it runs
    with the default only; the port's ``squared=True`` on squared distances
    is held to its own default on the distances."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((60, 3)) * np.array([2.0, 1.0, 0.05])).astype(np.float32)
    d = np.linalg.norm(x[:, None] - x[None], axis=-1).astype(np.float32)
    jr = jmds.mds(jnp.asarray(d), 3, estimate_dim=estimate_dim)
    tr = tmds.mds(torch.as_tensor(d), 3, estimate_dim=estimate_dim)
    np.testing.assert_allclose(tr.eigenvalues.numpy(), np.asarray(jr.eigenvalues), rtol=1e-4, atol=1e-3)
    assert int(tr.used_dims) == int(jr.used_dims)
    ge, je = tr.embedding.numpy(), np.asarray(jr.embedding)
    np.testing.assert_allclose(np.linalg.norm(ge[:, None] - ge[None], axis=-1),
                               np.linalg.norm(je[:, None] - je[None], axis=-1), rtol=0, atol=1e-4)
    sq = tmds.mds(torch.as_tensor(d * d), 3, squared=True, estimate_dim=estimate_dim)
    np.testing.assert_allclose(sq.eigenvalues.numpy(), tr.eigenvalues.numpy(), rtol=1e-5, atol=1e-5)


def test_mds_numpy_input_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmds.mds(np.eye(4, dtype=np.float32), 2)
    assert tmds.mds(np.eye(4, dtype=np.float32), 2, device="cpu").embedding.device.type == "cpu"
