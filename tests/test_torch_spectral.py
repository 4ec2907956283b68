"""The port's spectral clustering (``cilantro_tpu_torch/clustering/spectral.py``)
against the JAX package on the same numpy-seeded inputs, on the CPU, on
JAX's own draws: LOBPCG's start block ``jax.random.normal(e_key, (N, k))``
and k-means's per-centroid Gumbel noise, with ``k_key, e_key =
jax.random.split(key)`` as JAX splits them.

Tolerances: Laplacians 1e-6 absolute and relative (degree sums in another
order); eigenvalues 1e-4 (dense ``eigh``) and 1e-3
(LOBPCG in float32 with ``tol=0``); eigenvectors by the largest principal
angle between the two subspaces (< 1e-2 rad); labels as partitions (equal
after renaming), except where the eigengap estimate leaves k-means more
centroids than clusters: how a blob splits among the spare ones is float
order, so there each label must lie within one blob, on both sides. The port's LOBPCG (its own copy of JAX's
``lobpcg_standard``) is held to JAX's on one operator within 1e-4."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.sparse.linalg import lobpcg_standard

from cilantro_tpu.neighbors import knn_search as jknn
from cilantro_tpu_torch.neighbors import knn_search as tknn

js = importlib.import_module("cilantro_tpu.clustering.spectral")
ts = importlib.import_module("cilantro_tpu_torch.clustering.spectral")


def _blobs(seed, n_per=150, k=3, sep=6.0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.standard_normal((n_per, 3)) * 0.2 + sep * i for i in range(k)]).astype(np.float32)


def _graph(pts, k=8, sigma2=0.5):
    jnb = jknn(jnp.asarray(pts), jnp.asarray(pts), k, exclude_self=True)
    jw = jnp.where(jnb.mask, jnp.exp(-jnb.distances / sigma2), 0.0)
    idx, w, mask = np.array(jnb.indices), np.array(jw), np.array(jnb.mask)
    return (jnb.indices, jw, jnb.mask), tuple(torch.as_tensor(a) for a in (idx, w, mask))


def _affinity(pts, sigma2=0.5):
    d2 = np.sum((pts[:, None] - pts[None]) ** 2, -1)
    return np.exp(-d2 / sigma2).astype(np.float32)


def _max_angle(a, b):
    qa, qb = np.linalg.qr(np.asarray(a, np.float64))[0], np.linalg.qr(np.asarray(b, np.float64))[0]
    s = np.linalg.svd(qa.T @ qb, compute_uv=False)
    return float(np.arccos(np.clip(s.min(), -1.0, 1.0)))


def _same_partition(a, b):
    a, b = np.asarray(a), np.asarray(b)
    pairs = set(zip(a.tolist(), b.tolist()))
    assert len(pairs) == len(set(a.tolist())) == len(set(b.tolist())), pairs


def _kmeans_gumbel(key, k, n):
    keys = jax.random.split(key, k)
    return np.stack([np.asarray(jax.random.gumbel(keys[j], (n,), jnp.float32)) for j in range(k)])


@pytest.mark.parametrize("kind", ["normalized", "unnormalized", "random_walk"])
def test_dense_laplacian_and_embedding_match_jax(kind):
    pts = _blobs(0, n_per=40)
    aff = _affinity(pts)
    np.testing.assert_allclose(ts.laplacian(torch.as_tensor(aff), kind).numpy(),
                               np.asarray(js.laplacian(jnp.asarray(aff), kind)), rtol=1e-6, atol=1e-6)
    jemb, jvals = js.spectral_embedding(jnp.asarray(aff), 4, kind)
    temb, tvals = ts.spectral_embedding(torch.as_tensor(aff), 4, kind)
    np.testing.assert_allclose(tvals.numpy(), np.asarray(jvals), rtol=0, atol=1e-4)
    # The three zero modes are degenerate: compare the subspace of the first 3.
    assert _max_angle(temb[:, :3].numpy(), np.asarray(jemb)[:, :3]) < 1e-2
    assert int(ts.estimate_num_clusters_eigengap(tvals)) == int(js.estimate_num_clusters_eigengap(jvals)) == 3


@pytest.mark.parametrize("num_clusters", [3, None])
def test_dense_spectral_clustering_matches_jax(num_clusters):
    pts = _blobs(1, n_per=40)
    aff = _affinity(pts)
    key = jax.random.PRNGKey(0)
    j = js.spectral_clustering(key, jnp.asarray(aff), num_clusters)
    k_fit = 8 if num_clusters is None else num_clusters
    t = ts._spectral_clustering_from_draws(torch.as_tensor(_kmeans_gumbel(key, k_fit, len(pts))),
                                           torch.as_tensor(aff), num_clusters)
    assert int(t.num_clusters) == int(j.num_clusters) == 3
    _same_partition(t.labels.numpy(), j.labels)
    np.testing.assert_allclose(t.eigenvalues.numpy(), np.asarray(j.eigenvalues), rtol=0, atol=1e-4)


def test_lobpcg_matches_jax():
    rng = np.random.default_rng(2)
    n, k = 120, 4
    q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    a = ((q * np.linspace(0.0, 1.0, n)) @ q.T).astype(np.float32)
    x0 = rng.standard_normal((n, k)).astype(np.float32)
    jtheta, jx, ji = lobpcg_standard(jnp.asarray(a), jnp.asarray(x0), m=40, tol=0.0)
    ttheta, tx, ti = ts._lobpcg_standard(lambda v: torch.as_tensor(a) @ v, torch.as_tensor(x0), m=40, tol=0.0)
    assert ti == int(ji) == 40
    np.testing.assert_allclose(ttheta.numpy(), np.asarray(jtheta), rtol=0, atol=1e-4)
    assert _max_angle(tx.numpy(), np.asarray(jx)) < 1e-2
    # A positive tolerance stops early, as JAX's does.
    _, _, ji = lobpcg_standard(jnp.asarray(a), jnp.asarray(x0), m=200, tol=1e-3)
    _, _, ti = ts._lobpcg_standard(lambda v: torch.as_tensor(a) @ v, torch.as_tensor(x0), m=200, tol=1e-3)
    assert ti < 200 and abs(ti - int(ji)) <= 2


@pytest.mark.parametrize("kind", ["normalized", "unnormalized", "random_walk"])
def test_knn_embedding_matches_jax_on_its_start_block(kind):
    pts = _blobs(3, n_per=60, k=2)
    jg, tg = _graph(pts)
    key = jax.random.PRNGKey(1)
    jemb, jvals = js.spectral_embedding_knn(key, *jg, 4, kind=kind, max_iterations=60)
    x0 = np.asarray(jax.random.normal(key, (len(pts), 4), jnp.float32))
    temb, tvals = ts._spectral_embedding_knn_from_x0(torch.as_tensor(x0), *tg, kind=kind, max_iterations=60)
    np.testing.assert_allclose(tvals.numpy(), np.asarray(jvals), rtol=0, atol=1e-3)
    assert _max_angle(temb.numpy(), np.asarray(jemb)) < 1e-2


@pytest.mark.parametrize("num_clusters", [3, None])
def test_knn_spectral_clustering_matches_jax_on_its_draws(num_clusters):
    pts = _blobs(4)
    jg, tg = _graph(pts)
    key = jax.random.PRNGKey(0)
    j = js.spectral_clustering_knn(key, *jg, num_clusters, max_iterations=80)
    k_key, e_key = jax.random.split(key)
    k_emb = 8 if num_clusters is None else num_clusters
    x0 = np.asarray(jax.random.normal(e_key, (len(pts), k_emb), jnp.float32))
    t = ts._spectral_clustering_knn_from_draws(
        torch.as_tensor(x0), torch.as_tensor(_kmeans_gumbel(k_key, k_emb, len(pts))), *tg, num_clusters,
        max_iterations=80)
    assert int(t.num_clusters) == int(j.num_clusters) == 3
    blobs = np.repeat(np.arange(3), 150)
    if num_clusters is None:  # 8 centroids for 3 blobs
        for labels in (t.labels.numpy(), np.asarray(j.labels)):
            assert all(len(set(blobs[labels == c])) == 1 for c in set(labels.tolist()))
    else:
        _same_partition(t.labels.numpy(), j.labels)
        _same_partition(t.labels.numpy(), blobs)
    np.testing.assert_allclose(t.eigenvalues.numpy(), np.asarray(j.eigenvalues), rtol=0, atol=1e-3)


def test_public_entry_points_with_a_generator():
    pts = _blobs(5)
    idx, w, mask = _graph(pts)[1]
    res = ts.spectral_clustering_knn(torch.Generator().manual_seed(0), idx, w, mask, 3, max_iterations=60)
    labels = res.labels.numpy()
    _same_partition(labels, np.repeat(np.arange(3), 150))
    emb, vals = ts.spectral_embedding_knn(torch.Generator().manual_seed(1), idx, w, mask, 3, max_iterations=60)
    assert emb.shape == (450, 3) and float(vals.abs().max()) < 1e-3  # three components: three zero modes
    dense = ts.spectral_clustering(torch.Generator().manual_seed(2), _affinity(_blobs(6, n_per=30)), 3,
                                   device="cpu")
    _same_partition(dense.labels.numpy(), np.repeat(np.arange(3), 30))
