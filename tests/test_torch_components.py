"""The port's connected components (``cilantro_tpu_torch/clustering/
connected_components.py``) against the JAX package on the same
numpy-seeded inputs, on the CPU: label propagation, the size filters and
ranking, the evaluator gates, and the example's chain (``knn_search`` →
``edge_mask_from_evaluator`` → ``connected_components``) through each
package's own search.

Tolerance: exact. Labels, sizes and counts are integers from
scatter-mins and integer sums; the gates compare the same float32
expressions."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilantro_tpu.neighbors import knn_search as jknn
from cilantro_tpu.neighbors.api import Neighborhoods as JNb
from cilantro_tpu_torch import interop
from cilantro_tpu_torch.neighbors import knn_search as tknn

jc = importlib.import_module("cilantro_tpu.clustering.connected_components")
tc = importlib.import_module("cilantro_tpu_torch.clustering.connected_components")


def _strips(seed=0, per=300):
    """Four strips of points, two of them touching end to end, with normals
    that flip on one strip and colours that split another."""
    rng = np.random.default_rng(seed)
    parts = []
    for i, (x0, y0) in enumerate(((0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (3.0, 3.0))):
        p = np.zeros((per, 3), np.float32)
        p[:, 0] = x0 + rng.uniform(0, 1, per)
        p[:, 1] = y0 + rng.uniform(0, 0.05, per)
        parts.append(p)
    pts = np.concatenate(parts).astype(np.float32)
    nrm = np.tile(np.float32([0, 0, 1]), (len(pts), 1))
    nrm[2 * per:3 * per] = [1, 0, 0]
    col = np.zeros((len(pts), 3), np.float32)
    col[3 * per + per // 2:] = 1.0
    return pts, nrm, col


def _both(nb):
    arrays = [np.array(a) for a in (nb.indices, nb.distances, nb.mask)]
    return nb, interop.neighborhoods_from_numpy(*arrays, device="cpu")


def _same(t, j):
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    np.testing.assert_array_equal(t.sizes.numpy(), np.asarray(j.sizes))
    assert int(t.num_components) == int(j.num_components)


@pytest.mark.parametrize("case", ["distance", "normals", "colors", "all"])
def test_edge_masks_and_components_match_jax(case):
    pts, nrm, col = _strips()
    jnb, tnb = _both(jknn(jnp.asarray(pts), jnp.asarray(pts), 8, exclude_self=True))
    kw = dict(max_distance=0.08)
    if case in ("normals", "all"):
        kw["max_normal_angle"] = 0.3
    if case in ("colors", "all"):
        kw["max_color_diff"] = 0.5
    jm = jc.edge_mask_from_evaluator(jnb, jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(col), **kw)
    tm = tc.edge_mask_from_evaluator(tnb, torch.as_tensor(pts), torch.as_tensor(nrm), torch.as_tensor(col), **kw)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    _same(tc.connected_components(tnb, edge_mask=tm), jc.connected_components(jnb, edge_mask=jm))


@pytest.mark.parametrize("min_size, max_size, masked", [(1, None, False), (100, None, True), (1, 400, False)])
def test_size_filters_and_valid_mask_match_jax(min_size, max_size, masked):
    rng = np.random.default_rng(1)
    pts = np.concatenate([rng.uniform(0, 1, (500, 3)) * 0.3, rng.uniform(2, 2.2, (60, 3)),
                          rng.uniform(5, 5.5, (300, 3))]).astype(np.float32)
    valid = rng.random(len(pts)) < 0.9 if masked else None
    jnb, tnb = _both(jknn(jnp.asarray(pts), jnp.asarray(pts), 6, exclude_self=True))
    kw = dict(min_size=min_size, max_size=max_size)
    j = jc.connected_components(jnb, valid=None if valid is None else jnp.asarray(valid), **kw)
    t = tc.connected_components(tnb, valid=None if valid is None else torch.as_tensor(valid), **kw)
    _same(t, j)
    assert t.labels.dtype == torch.int32


def test_propagate_labels_on_a_directed_random_graph():
    rng = np.random.default_rng(2)
    n, k = 700, 3
    idx = rng.integers(0, n, (n, k)).astype(np.int32)
    mask = rng.random((n, k)) < 0.35
    valid = rng.random(n) < 0.95
    for rounds in (None, 2):
        want = jc.propagate_labels(jnp.asarray(idx), jnp.asarray(mask), jnp.asarray(valid), rounds)
        got = tc.propagate_labels(torch.as_tensor(idx), torch.as_tensor(mask), torch.as_tensor(valid), rounds)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_the_examples_chain_through_each_packages_search():
    """Each package's own kNN search, then the gate and the components: the
    same labels (the searches' near-ties do not reach the gate here)."""
    pts, _, _ = _strips(3, per=400)
    jnb = jknn(jnp.asarray(pts), jnp.asarray(pts), 8, exclude_self=True)
    tnb = tknn(torch.as_tensor(pts), torch.as_tensor(pts), 8, exclude_self=True)
    j = jc.connected_components(jnb, edge_mask=jc.edge_mask_from_evaluator(jnb, jnp.asarray(pts), max_distance=0.05),
                                min_size=50)
    t = tc.connected_components(tnb, edge_mask=tc.edge_mask_from_evaluator(tnb, torch.as_tensor(pts),
                                                                           max_distance=0.05), min_size=50)
    _same(t, j)
    assert int(t.num_components) == 3  # two strips touch end to end


def test_components_of_jax_neighborhoods_leaves():
    jnb = JNb(jnp.asarray(np.int32([[1], [0], [3], [2]])), jnp.zeros((4, 1)), jnp.ones((4, 1), bool))
    _, tnb = _both(jnb)
    t = tc.connected_components(tnb)
    assert int(t.num_components) == 2 and t.sizes.tolist() == [2, 2, 0, 0]
