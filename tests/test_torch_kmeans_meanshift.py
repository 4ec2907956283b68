"""The port's k-means and mean shift (``cilantro_tpu_torch/clustering/kmeans.py``,
``clustering/mean_shift.py``) against the JAX package on the same
numpy-seeded inputs, on the CPU. k-means runs on JAX's own draws: the
per-centroid Gumbel noise ``jax.random.gumbel(keys[j], (N,))`` of
``keys = jax.random.split(key, k)`` (JAX's ``categorical`` is
``argmax(logits + gumbel)``) for k-means++, ``jax.random.uniform(key, (N,))``
for the random init.

Tolerances: the same iteration count, labels and cluster count exactly;
centroids and modes 1e-5 (float32 sums in another order)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jk = importlib.import_module("cilantro_tpu.clustering.kmeans")
jm = importlib.import_module("cilantro_tpu.clustering.mean_shift")
tk = importlib.import_module("cilantro_tpu_torch.clustering.kmeans")
tm = importlib.import_module("cilantro_tpu_torch.clustering.mean_shift")


def _blobs(seed=0, k=5, per=300, scale=0.3):
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-3, 3, (k, 3))
    return np.concatenate([c + scale * rng.standard_normal((per, 3)) for c in centres]).astype(np.float32)


def _jax_draws(key, init, k, n):
    if init == "random":
        return np.array(jax.random.uniform(key, (n,)))
    keys = jax.random.split(key, k)
    return np.stack([np.asarray(jax.random.gumbel(keys[j], (n,), jnp.float32)) for j in range(k)])


def _same_kmeans(t, j, atol=1e-5):
    assert int(t.iterations) == int(j.iterations)
    assert bool(t.converged) == bool(j.converged)
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids), rtol=0, atol=atol)


@pytest.mark.parametrize("init, k, metric, masked", [
    ("k-means++", 5, "l2", False), ("k-means++", 8, "l2", True), ("random", 5, "l2", False),
    ("k-means++", 4, "l1", False),
])
def test_kmeans_matches_jax_on_its_draws(init, k, metric, masked):
    pts = _blobs()
    valid = np.random.default_rng(3).random(len(pts)) < 0.85 if masked else None
    key = jax.random.PRNGKey(2)
    j = jk.kmeans(key, jnp.asarray(pts), k, init=init, metric=metric,
                  valid=None if valid is None else jnp.asarray(valid))
    t = tk._kmeans_from_draws(torch.as_tensor(_jax_draws(key, init, k, len(pts))), torch.as_tensor(pts), k,
                              init=init, metric=metric, valid=None if valid is None else torch.as_tensor(valid))
    _same_kmeans(t, j)
    assert t.labels.dtype == torch.int32 and t.iterations.dtype == torch.int32


def test_kmeans_repairs_empty_clusters_as_jax():
    """Points on three sites and k = 6: random inits coincide, the
    duplicates' clusters empty, and each takes a far point."""
    rng = np.random.default_rng(4)
    sites = np.repeat(np.float32([[0, 0, 0], [4, 0, 0], [0, 4, 0]]), 100, axis=0)
    pts = np.concatenate([sites, rng.uniform(-1, 5, (12, 3)).astype(np.float32)])
    key = jax.random.PRNGKey(11)
    j = jk.kmeans(key, jnp.asarray(pts), 6, init="random")
    draws = torch.as_tensor(_jax_draws(key, "random", 6, len(pts)))
    p, every = torch.as_tensor(pts), torch.ones(len(pts), dtype=torch.bool)
    labels, _ = tk._assign(p, p[torch.topk(-draws, 6).indices], every)
    _, counts = tk._update(p, labels, every, 6)
    assert int((counts == 0).sum()) > 0  # the case exercises the repair
    _same_kmeans(tk._kmeans_from_draws(draws, p, 6, init="random"), j)


def test_kmeans_public_entry_with_a_generator():
    pts = _blobs(5, k=3, per=200, scale=0.2)
    a = tk.kmeans(torch.Generator().manual_seed(0), pts, 3, device="cpu")
    b = tk.kmeans(torch.Generator().manual_seed(0), torch.as_tensor(pts), 3)
    assert torch.equal(a.labels, b.labels) and bool(a.converged)
    for blk in np.split(a.labels.numpy(), 3):
        assert (blk == blk[0]).all()
    assert len(set(a.labels.numpy().tolist())) == 3
    r = tk.kmeans(torch.Generator().manual_seed(1), torch.as_tensor(pts), 3, init="random")
    assert r.centroids.shape == (3, 3) and torch.isfinite(r.centroids).all()
    with pytest.raises(ValueError, match="unknown init"):
        tk.kmeans(None, torch.as_tensor(pts), 3, init="nope")


@pytest.mark.parametrize("case", ["dense_flat", "dense_gaussian", "dense_seeds_valid", "capped", "capped_overflow"])
def test_mean_shift_matches_jax(case):
    pts = _blobs(6, k=4, per=150, scale=0.25)[::2]
    kw = dict(radius=1.0)
    jkw, tkw = {}, {}
    if case == "dense_gaussian":
        kw.update(kernel="gaussian", merge_distance=0.3)
    if case == "dense_seeds_valid":
        valid = np.random.default_rng(7).random(len(pts)) < 0.8
        jkw = dict(seeds=jnp.asarray(pts[::5]), valid=jnp.asarray(valid))
        tkw = dict(seeds=torch.as_tensor(pts[::5]), valid=torch.as_tensor(valid))
    if case == "capped":
        kw.update(max_neighbors=160)
    if case == "capped_overflow":
        kw.update(max_neighbors=16, merge_cap=8)
    j = jm.mean_shift(jnp.asarray(pts), **kw, **jkw)
    t = tm.mean_shift(torch.as_tensor(pts), **kw, **tkw)
    assert int(t.iterations) == int(j.iterations)
    assert int(t.num_clusters) == int(j.num_clusters)
    assert bool(t.overflowed) == bool(j.overflowed) == (case == "capped_overflow")
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    np.testing.assert_allclose(t.modes.numpy(), np.asarray(j.modes), rtol=0, atol=1e-5)


def test_mean_shift_weight_fn_and_merge_labels():
    pts = _blobs(8, k=2, per=100, scale=0.2)
    j = jm.mean_shift(jnp.asarray(pts), 1.0, weight_fn=lambda d2: 1.0 / (1.0 + d2))
    t = tm.mean_shift(torch.as_tensor(pts), 1.0, weight_fn=lambda d2: 1.0 / (1.0 + d2))
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    adj = np.random.default_rng(9).random((40, 40)) < 0.04
    adj = adj | adj.T
    np.testing.assert_array_equal(tm._merge_labels(torch.as_tensor(adj)).numpy(),
                                  np.asarray(jm._merge_labels(jnp.asarray(adj))))
    with pytest.raises(ValueError, match="unknown kernel"):
        tm.mean_shift(torch.as_tensor(pts), 1.0, kernel="box")
