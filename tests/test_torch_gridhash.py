"""The port's grid radius search (``cilantro_tpu_torch/neighbors/gridhash.py``)
against ``cilantro_tpu/neighbors/gridhash.py`` on the CPU.

Sorts, tiles and boxes are selection results and must be equal. The
results: overflow flags and hit masks exactly (no key of these clouds lies
within float32 rounding of the radius); distances within ``4e-6 · max(1,
‖q‖²)`` (float32 rounding of ‖q‖² + ‖k‖² − 2q·k in another summation
order); indices equal except between keys tied within that tolerance in
float64.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cilantro_tpu.neighbors import gridhash as jgh
from cilantro_tpu_torch.neighbors import gridhash as tgh

INVALID = 3.0e38


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(q, k, got, want, radius):
    (dt, it, ot), (dj, ij, oj) = got, [np.asarray(a) for a in want]
    dt, it, ot = dt.numpy(), it.numpy(), ot.numpy()
    assert dt.shape == dj.shape
    np.testing.assert_array_equal(ot, oj)
    hit = dj < INVALID * 0.5
    np.testing.assert_array_equal(dt < INVALID * 0.5, hit)
    ok = np.abs(q).max(1) < 1e29
    atol = 4e-6 * max(1.0, float((q[ok].astype(np.float64) ** 2).sum(1).max()))
    np.testing.assert_allclose(dt[hit], dj[hit], rtol=0, atol=atol)
    rows, cols = np.nonzero(hit & (it != ij))
    q64, k64 = q.astype(np.float64), k.astype(np.float64)
    dp = ((q64[rows] - k64[it[rows, cols]]) ** 2).sum(1)
    dq = ((q64[rows] - k64[ij[rows, cols]]) ** 2).sum(1)
    assert np.all(np.abs(dp - dq) <= 2 * atol)
    assert np.all(dt[hit] <= np.float32(radius * radius) + atol)


def _cloud(seed, n, dim, lo=-0.2, hi=0.2):
    rng = np.random.default_rng(seed)
    return rng, rng.uniform(lo, hi, (n, dim)).astype(np.float32)


def test_sort_tiles_matches_jax():
    rng, pts = _cloud(0, 1000, 3)
    pts[::9] = pts[4]  # equal codes: the sort must be stable
    valid = rng.random(1000) < 0.85
    pts[~valid] = 1e30
    origin = pts[valid].min(0)
    want = jgh._sort_tiles(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(origin), 0.02, 128)
    got = tgh._sort_tiles(_t(pts), _t(valid), _t(origin), torch.tensor(np.float32(0.02)), 128)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize(
    "dim,radius,cap,max_key_tiles,exclude_self",
    [
        (3, 0.04, 8, 32, False),  # capacity overflow on dense balls
        (3, 0.04, 64, 32, False),  # roomy: no flag
        (3, 0.05, 16, 2, False),  # tile budget overflow
        (3, 0.06, 6, 32, True),
        (2, 0.02, 10, 32, False),
    ],
)
def test_radius_search_grid_matches_jax(dim, radius, cap, max_key_tiles, exclude_self):
    rng, keys = _cloud(1 + dim, 1500, dim)
    q = keys[:600] if exclude_self else rng.uniform(-0.2, 0.2, (600, dim)).astype(np.float32)
    if exclude_self:
        keys = q
    kv = rng.random(len(keys)) < 0.9
    qv = rng.random(len(q)) < 0.95
    kw = dict(tile=128, max_key_tiles=max_key_tiles, exclude_self=exclude_self)
    want = jgh.radius_search_grid(
        jnp.asarray(q), jnp.asarray(keys), radius, cap, query_valid=jnp.asarray(qv),
        key_valid=jnp.asarray(kv), **kw,
    )
    got = tgh.radius_search_grid(_t(q), _t(keys), radius, cap, query_valid=_t(qv), key_valid=_t(kv), **kw)
    _close(q, keys, got, want, radius)
    over = np.asarray(want[2])
    if cap == 64:
        assert not over.any()
    else:
        assert over.any()  # the case exercises its flag


def test_radius_search_grid_flags_invalid_points():
    """Points at 1e30 (masked, as depth_to_points leaves them) neither hit
    nor flag."""
    rng, keys = _cloud(7, 800, 3)
    keys[::5] = 1e30
    valid = keys[:, 0] < 1e29
    want = jgh.radius_search_grid(
        jnp.asarray(keys), jnp.asarray(keys), 0.03, 12, query_valid=jnp.asarray(valid),
        key_valid=jnp.asarray(valid), tile=128,
    )
    got = tgh.radius_search_grid(_t(keys), _t(keys), 0.03, 12, query_valid=_t(valid),
                                 key_valid=_t(valid), tile=128)
    _close(keys, keys, got, want, 0.03)
    assert not got[2].numpy()[~valid].any()
