"""The port's neighbourhood API (``cilantro_tpu_torch/neighbors/api.py``)
against ``cilantro_tpu/neighbors/api.py`` on the CPU, backend by backend.

The ``pruned`` backends run JAX's Pallas kernels in interpret mode (both
packages' engines are patched to the tiles of ``tests/test_pallas_nn.py``,
128/256, so that the interpreted grids stay small); ``auto`` takes the
tiled scan or brute force on the CPU in both packages, ``grid`` the grid
search.

Tolerances, as in ``tests/test_torch_knn.py``: masks and overflow flags
exactly (no key of these clouds lies within float32 rounding of a radius);
distances within ``4e-6 · max(1, ‖q‖²)`` (float32 rounding of ‖q‖² + ‖k‖² −
2q·k summed in another order); a differing index only between keys tied
within that tolerance in float64.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilantro_tpu.neighbors import api as japi
from cilantro_tpu.neighbors import bruteforce as jbf
from cilantro_tpu.neighbors import pallas_nn as jnn
from cilantro_tpu_torch.neighbors import api as tapi
from cilantro_tpu_torch.neighbors import fused_knn as tk

TILES = dict(tile_q=128, tile_m=256)


@pytest.fixture()
def small_tiles(monkeypatch):
    """Both packages' pruned engines at 128/256 tiles (JAX interpreted), and
    JAX's tiled scan at 128/512 instead of 1024/2048, which pad these
    clouds to twice their rows or more (the tiles change no result)."""
    for name in ("knn_pruned", "radius_search_pruned"):
        monkeypatch.setattr(jnn, name, functools.partial(getattr(jnn, name), interpret=True, **TILES))
        monkeypatch.setattr(tk, name, functools.partial(getattr(tk, name), **TILES))
    scan = jbf._knn_xla
    monkeypatch.setattr(jbf, "_knn_xla", lambda *a, tile_q, tile_m, **kw: scan(*a, tile_q=128, tile_m=512, **kw))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _assert_nb_close(q, k, got, want):
    """``got`` (port) against ``want`` (JAX) Neighborhoods."""
    assert got.indices.dtype == torch.int32 and got.indices.shape == want.indices.shape
    mask = np.asarray(want.mask)
    np.testing.assert_array_equal(got.mask.numpy(), mask)
    if want.overflowed is None:
        assert got.overflowed is None
    else:
        np.testing.assert_array_equal(got.overflowed.numpy(), np.asarray(want.overflowed))
    dt, dj = got.distances.numpy(), np.asarray(want.distances)
    ok = np.abs(q).max(1) < 1e29
    atol = 4e-6 * max(1.0, float((q[ok].astype(np.float64) ** 2).sum(1).max()))
    np.testing.assert_allclose(dt[mask], dj[mask], rtol=0, atol=atol)
    np.testing.assert_array_equal(dt[~mask], dj[~mask])
    it, ij = got.indices.numpy(), np.asarray(want.indices)
    np.testing.assert_array_equal(it[~mask], 0)
    rows, cols = np.nonzero(mask & (it != ij))
    q64, k64 = q.astype(np.float64), k.astype(np.float64)
    dp = ((q64[rows] - k64[it[rows, cols]]) ** 2).sum(1)
    dq = ((q64[rows] - k64[ij[rows, cols]]) ** 2).sum(1)
    assert np.all(np.abs(dp - dq) <= 2 * atol), f"{len(rows)} differing indices, not all ties"


def _clouds(seed=0, qn=400, mn=1200):
    rng = np.random.default_rng(seed)
    keys = rng.uniform(-0.2, 0.2, (mn, 3)).astype(np.float32)
    q = rng.uniform(-0.2, 0.2, (qn, 3)).astype(np.float32)
    kv = rng.random(mn) < 0.9
    qv = rng.random(qn) < 0.95
    return q, keys, qv, kv


@pytest.mark.parametrize("backend", ["auto", "brute", "pruned"])
@pytest.mark.parametrize("exclude_self", [False, True])
def test_knn_search_matches_jax(small_tiles, backend, exclude_self):
    q, keys, qv, kv = _clouds(1)
    if exclude_self:
        keys, kv = q, qv
    kw = dict(query_valid=qv, key_valid=kv, exclude_self=exclude_self, backend=backend)
    want = japi.knn_search(_j(q), _j(keys), 9, **{n: _j(v) if isinstance(v, np.ndarray) else v
                                                   for n, v in kw.items()})
    got = tapi.knn_search(_t(q), _t(keys), 9, **{n: _t(v) if isinstance(v, np.ndarray) else v
                                                  for n, v in kw.items()})
    _assert_nb_close(q, keys, got, want)
    assert int(got.counts().min()) in (0, 9) and got.k == 9


def test_knn_search_l1_and_its_refusals(small_tiles):
    q, keys, qv, kv = _clouds(2)
    want = japi.knn_search(_j(q), _j(keys), 5, metric="l1", key_valid=_j(kv))
    got = tapi.knn_search(_t(q), _t(keys), 5, metric="l1", key_valid=_t(kv))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.distances.numpy(), np.asarray(want.distances), rtol=0, atol=1e-6)
    assert (got.indices.numpy() == np.asarray(want.indices)).mean() > 0.99  # L1 ties
    with pytest.raises(ValueError, match="unknown backend"):
        tapi.knn_search(_t(q), _t(keys), 5, backend="grid")
    with pytest.raises(ValueError, match="3D only"):
        tapi.knn_search(_t(q), _t(keys), 5, metric="l1", backend="pruned")


@pytest.mark.parametrize("backend", ["auto", "brute", "grid", "pruned"])
@pytest.mark.parametrize("exclude_self,cap,radius", [(False, 8, 0.04), (True, 6, 0.04), (False, 8, 0.03)])
def test_radius_search_matches_jax(small_tiles, backend, exclude_self, cap, radius):
    """At 0.04 caps 8 and 6 overflow on the densest balls; at 0.03 no ball
    holds more than 7 keys (the radius is traced, so the case reuses the
    first one's compiled JAX programs)."""
    q, keys, qv, kv = _clouds(3)
    if exclude_self:  # the denser cloud, so that balls overflow
        q, qv = keys, kv
    kw = dict(query_valid=qv, key_valid=kv, exclude_self=exclude_self, backend=backend)
    want = japi.radius_search(_j(q), _j(keys), radius, cap, **{
        n: _j(v) if isinstance(v, np.ndarray) else v for n, v in kw.items()})
    got = tapi.radius_search(_t(q), _t(keys), radius, cap, **{
        n: _t(v) if isinstance(v, np.ndarray) else v for n, v in kw.items()})
    _assert_nb_close(q, keys, got, want)
    assert bool(got.overflowed.any()) == (radius == 0.04)


def test_knn_in_radius_search_and_refusals(small_tiles):
    q, keys, qv, kv = _clouds(4)
    want = japi.knn_in_radius_search(_j(q), _j(keys), 7, 0.03, key_valid=_j(kv))
    got = tapi.knn_in_radius_search(_t(q), _t(keys), 7, 0.03, key_valid=_t(kv))
    _assert_nb_close(q, keys, got, want)
    with pytest.raises(ValueError, match="2D/3D only"):
        tapi.radius_search(_t(q), _t(keys), 0.03, 7, metric="l1", backend="grid")
    with pytest.raises(ValueError, match="3D only"):
        tapi.radius_search(_t(q[:, :2]), _t(keys[:, :2]), 0.03, 7, backend="pruned")


def test_auto_picks_the_jax_backends_for_cuda_tensors(monkeypatch):
    """``auto`` on CUDA tensors: the pruned radius search for large 3-D L2
    searches with a cap of at most 16, the grid above 16 or in 2-D, brute
    force for small problems (the JAX rules with "TPU" read as CUDA). The
    engines are replaced by recorders, so no card is needed."""
    from cilantro_tpu_torch.neighbors import gridhash

    calls = []

    def recorder(name):
        def engine(queries, keys, radius, cap, **kw):
            calls.append(name)
            shape = (queries.shape[0], cap)
            return (torch.zeros(shape), torch.zeros(shape, dtype=torch.int32),
                    torch.zeros(queries.shape[0], dtype=torch.bool))
        return engine

    monkeypatch.setattr(tk, "radius_search_pruned", recorder("pruned"))
    monkeypatch.setattr(gridhash, "radius_search_grid", recorder("grid"))
    monkeypatch.setattr(tapi, "knn_search", lambda *a, **kw: calls.append("brute") or
                        tapi._finish(torch.zeros((a[0].shape[0], a[2])),
                                     torch.zeros((a[0].shape[0], a[2]), dtype=torch.int32)))

    class Cuda(torch.Tensor):  # a CPU tensor that reports a CUDA device
        @property
        def device(self):
            return torch.device("cuda")

    big = torch.zeros((1 << 13, 3)).as_subclass(Cuda)  # Q·M = 2^26
    big2d = torch.zeros((1 << 13, 2)).as_subclass(Cuda)
    small = torch.zeros((100, 3)).as_subclass(Cuda)
    for args in ((big, big, 0.01, 16), (big, big, 0.01, 17), (big2d, big2d, 0.01, 8),
                 (small, small, 0.01, 8)):
        tapi.radius_search(*args)
    assert calls == ["pruned", "grid", "grid", "brute"]
