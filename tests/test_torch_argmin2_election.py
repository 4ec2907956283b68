"""The exactness argument of the CUDA ``splat_argmin2`` kernel, in plain
PyTorch (no JAX, no card).

The kernel sends every source to the target its offset code names and
elects, per target, the smallest and second-smallest packed value
``(order_key(key, -0 as +0) << 32) | v``, ``v = (layer << 16) | code``, by
two sweeps of a scatter minimum; the second sweep skips each target's own
best. Keys are then re-read from the winning sources. A model of those
steps must give ``splat_argmin2_plain``'s sequential strict-``<`` sweep
bit for bit.
"""

import numpy as np
import pytest
import torch

from cilantro_tpu_torch.slam import splat

EMPTY = torch.iinfo(torch.int64).max


def _order_key(key: torch.Tensor) -> torch.Tensor:
    """The float order as a signed int64 in [-2^31, 2^31), -0 as +0."""
    b = key.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = torch.where(b == 0x80000000, 0, b)
    u = torch.where(b >= 0x80000000, b ^ 0xFFFFFFFF, b | 0x80000000)
    return u - 2**31


def election_model(key: torch.Tensor, off: torch.Tensor, r: int):
    """The kernel's two-sweep election over the padded ``(B, L, H+2R,
    W+2R)`` inputs."""
    b, layers, hp, wp = key.shape
    h, w = hp - 2 * r, wp - 2 * r
    w2 = 2 * r + 1
    n_oc = w2 * w2
    bi, li, py, px = torch.meshgrid(*(torch.arange(n) for n in key.shape), indexing="ij")
    ty = py - r + torch.div(off, w2, rounding_mode="floor") - r
    tx = px - r + off % w2 - r
    lands = (off >= 0) & (off < n_oc) & (ty >= 0) & (ty < h) & (tx >= 0) & (tx < w) & (key < np.inf)
    target = ((bi * h + ty) * w + tx)[lands]
    packed = _order_key(key[lands]) * 2**32 + (li * 2**16 + off)[lands]
    best = torch.full((b * h * w,), EMPTY).scatter_reduce(0, target, packed, "amin")
    other = packed != best[target]
    sec = torch.full((b * h * w,), EMPTY).scatter_reduce(0, target[other], packed[other], "amin")
    out = []
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    for slot in (best.reshape(b, h, w), sec.reshape(b, h, w)):
        v = torch.where(slot == EMPTY, 0, slot & 0xFFFFFFFF)
        l, oc = v >> 16, v & 0xFFFF
        src_y = ys + 2 * r - torch.div(oc, w2, rounding_mode="floor")
        src_x = xs + 2 * r - oc % w2
        k = key[torch.arange(b)[:, None, None], l, src_y, src_x]
        out.append(torch.where(slot == EMPTY, float("inf"), k))
        out.append(torch.where(slot == EMPTY, -1, oc * layers + l).to(torch.int32))
    return out[0], out[1], out[2], out[3]


def edge_case_inputs(seed: int, r: int, b: int = 2, layers: int = 2, h: int = 37, w: int = 45):
    """Padded keys and codes with every case the argument names: keys from
    a few values (ties), -0 and +0, NaN, +inf; codes -1, in range and past
    (2R+1)²; pad sources with codes in range (some land inside the frame,
    some outside it). H and W are not multiples of the kernel's tile."""
    rng = np.random.default_rng(seed)
    w2 = 2 * r + 1
    shape = (b, layers, h + 2 * r, w + 2 * r)
    key = rng.choice(np.float32([0.5, 1.0, 1.5, 0.0, -0.0, np.nan, np.inf, -1.0]), shape,
                     p=[0.25, 0.2, 0.1, 0.15, 0.15, 0.05, 0.05, 0.05]).astype(np.float32)
    # Codes favour small offsets, so that many sources land on one target.
    off = rng.integers(0, w2 * w2, shape).astype(np.int32)
    near = rng.random(shape) < 0.5
    off[near] = (r * w2 + r + rng.integers(-1, 2, shape) * w2 + rng.integers(-1, 2, shape))[near]
    u = rng.random(shape)
    off[u < 0.08] = -1
    off[(u >= 0.08) & (u < 0.12)] = w2 * w2 + rng.integers(0, 5, shape)[(u >= 0.08) & (u < 0.12)]
    return torch.from_numpy(key), torch.from_numpy(off)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("r", [1, 2, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_election_model_is_the_sequential_sweep(r, seed):
    key, off = edge_case_inputs(seed, r)
    want = splat.splat_argmin2_plain(key, off, r)
    got = election_model(key, off, r)
    for g, p in zip(got, want):
        assert torch.equal(_bits(g), _bits(p))
    bk, bc, sk, sc = want
    # The cases were there: ties decided by visit order, signed zeros kept,
    # runner-ups of equal key, empty targets.
    assert (bk == sk).any()
    assert ((bk == 0) & torch.signbit(bk)).any() and ((sk == 0) & torch.signbit(sk)).any()
    assert (sc == -1).any() and (sc >= 0).any()


def test_pad_sources_land_only_inside_the_frame():
    """A source in the pad whose code points into the frame is a candidate;
    one whose code points further out is not."""
    r, h, w = 2, 5, 6
    w2 = 2 * r + 1
    key = torch.full((1, 1, h + 2 * r, w + 2 * r), float("inf"))
    off = torch.full(key.shape, -1, dtype=torch.int32)
    # Pad source at padded (0, 3): (dv, du) = (2, 0) lands on (0, 1).
    key[0, 0, 0, 3], off[0, 0, 0, 3] = 0.25, (2 + r) * w2 + r
    # Pad source at padded (1, 3): (dv, du) = (-1, 0) lands on (-2, 1), outside.
    key[0, 0, 1, 3], off[0, 0, 1, 3] = 0.125, (-1 + r) * w2 + r
    want = splat.splat_argmin2_plain(key, off, r)
    got = election_model(key, off, r)
    for g, p in zip(got, want):
        assert torch.equal(_bits(g), _bits(p))
    assert want[1][0, 0, 1] == (2 + r) * w2 + r and (want[1] >= 0).sum() == 1
