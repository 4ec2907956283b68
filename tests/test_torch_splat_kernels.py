"""The port's splat kernels (``cilantro_tpu_torch/slam/splat.py``) against
the JAX package's Pallas kernels, run in interpret mode on the CPU.

The three kernels are pure selects, so the port's plain versions must
match the Pallas kernels bit for bit (float outputs are compared as int32
views). Inputs follow ``tests/test_splat.py``: 2 layers, 32×48 pixels,
about 1/(2R+1)² of the offsets/codes -1, offsets that reach into the pad.
The CUDA kernels are held against the plain versions in
``tests/test_torch_splat_cuda.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cilantro_tpu.slam import splat as jsplat
from cilantro_tpu_torch import native
from cilantro_tpu_torch.slam import splat as tsplat

LAYERS, H, W = 2, 32, 48
RADII = (1, 2, 3, 4, 5)


def _chans(r):
    """(row, image) channels: ``tests/test_splat.py``'s 5 and 3 at its
    radius 2, else 2 each (interpret mode unrolls every channel of every
    offset, so channels cost JAX time and add no coverage)."""
    return (5, 3) if r == 2 else (2, 2)


def _bits(x) -> np.ndarray:
    """int32 view of a float32 or int32 array (JAX or torch)."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(a).view(np.int32)


def _key_off(rng, r, layers=LAYERS, h=H, w=W):
    """Padded (B=1) key/off planes: random keys, +inf where off is -1,
    with a few exact key ties so the (layer, dv, du) tie order matters."""
    w2 = 2 * r + 1
    key = rng.random((layers, h, w)).astype(np.float32)
    key[rng.random((layers, h, w)) < 0.2] = 0.5
    off = rng.integers(-1, w2 * w2, size=(layers, h, w)).astype(np.int32)
    key[off < 0] = np.inf
    key_p = np.pad(key, ((0, 0), (r, r), (r, r)), constant_values=np.inf)[None]
    off_p = np.pad(off, ((0, 0), (r, r), (r, r)), constant_values=-1)[None]
    return key_p, off_p


def _codes(rng, r, layers=LAYERS, h=H, w=W):
    w2 = 2 * r + 1
    return rng.integers(-1, layers * w2 * w2, size=(1, h, w)).astype(np.int32)


@pytest.mark.parametrize("r", RADII)
def test_plain_argmin2_matches_pallas(r):
    rng = np.random.default_rng(10 + r)
    key_p, off_p = _key_off(rng, r)
    want = jsplat.splat_argmin2(jnp.asarray(key_p), jnp.asarray(off_p), radius=r)
    got = tsplat.splat_argmin2(
        torch.from_numpy(key_p), torch.from_numpy(off_p), radius=r
    )
    for name, g, e in zip(("best_key", "best_code", "sec_key", "sec_code"), got, want):
        assert tuple(g.shape) == (1, H, W), name
        np.testing.assert_array_equal(_bits(g), _bits(e), err_msg=f"{name} r={r}")
    # The election found something: most pixels have a winner.
    assert (got[1] >= 0).float().mean() > 0.5


@pytest.mark.parametrize("r", RADII)
def test_plain_select_rows_matches_pallas(r):
    rng = np.random.default_rng(20 + r)
    row_chans, _ = _chans(r)
    rows = rng.standard_normal((1, LAYERS, row_chans, H, W)).astype(np.float32)
    rows_p = np.pad(rows, ((0, 0),) * 3 + ((r, r), (r, r)))
    code = _codes(rng, r)
    want = jsplat.flow_select_rows(jnp.asarray(rows_p), jnp.asarray(code), radius=r)
    got = tsplat.flow_select_rows(
        torch.from_numpy(rows_p), torch.from_numpy(code), radius=r
    )
    assert tuple(got.shape) == (1, row_chans, H, W)
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=f"r={r}")


@pytest.mark.parametrize("r", RADII)
def test_plain_window_read_matches_pallas(r):
    rng = np.random.default_rng(30 + r)
    w2 = 2 * r + 1
    _, img_chans = _chans(r)
    img = rng.integers(-1000, 1000, size=(1, img_chans, H, W)).astype(np.int32)
    img_p = np.pad(img, ((0, 0), (0, 0), (r, r), (r, r)), constant_values=-1)
    off = rng.integers(-1, w2 * w2, size=(1, H, W)).astype(np.int32)
    want = jsplat.window_read_codes(jnp.asarray(img_p), jnp.asarray(off), radius=r)
    got = tsplat.window_read_codes(
        torch.from_numpy(img_p), torch.from_numpy(off), radius=r
    )
    assert tuple(got.shape) == (1, img_chans, H, W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"r={r}")
    # Reads that land in the pad return the pad's -1.
    assert (got.numpy() == -1).any(axis=1).mean() > (off < 0).mean()


def test_offset_code_roundtrip_matches_jax():
    r = 3
    w2 = 2 * r + 1
    dv, du = np.meshgrid(np.arange(-r - 2, r + 3), np.arange(-r - 2, r + 3), indexing="ij")
    dv, du = dv.astype(np.int32), du.astype(np.int32)
    got = tsplat.offset_code(torch.from_numpy(du), torch.from_numpy(dv), r).numpy()
    want = np.asarray(jsplat.offset_code(jnp.asarray(du), jnp.asarray(dv), r))
    np.testing.assert_array_equal(got, want)
    inside = (np.abs(dv) <= r) & (np.abs(du) <= r)
    np.testing.assert_array_equal(got[inside] // w2 - r, dv[inside])
    np.testing.assert_array_equal(got[inside] % w2 - r, du[inside])
    assert (got[~inside] == -1).all()


def test_wrappers_take_broadcast_batches_and_check_arguments():
    """A stride-0 batch (one frame read by every layer, one map serving
    winner and runner-up) gives the same answer as a materialised one; bad
    dtypes and shapes raise; CPU calls launch no kernel."""
    r = 2
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.integers(-9, 9, size=(1, 2, H + 2 * r, W + 2 * r)).astype(np.int32))
    off = torch.from_numpy(rng.integers(-1, 25, size=(2, H, W)).astype(np.int32))
    before = dict(native.launch_counts)
    a = tsplat.window_read_codes(img.expand(2, -1, -1, -1), off, radius=r)
    b = tsplat.window_read_codes(img.expand(2, -1, -1, -1).contiguous(), off, radius=r)
    assert torch.equal(a, b)
    rows = torch.from_numpy(rng.standard_normal((1, LAYERS, 3, H + 2 * r, W + 2 * r)).astype(np.float32))
    code = torch.from_numpy(_codes(rng, r)).expand(2, -1, -1).contiguous()
    a = tsplat.flow_select_rows(rows.expand(2, -1, -1, -1, -1), code, radius=r)
    b = tsplat.flow_select_rows(rows.expand(2, -1, -1, -1, -1).contiguous(), code, radius=r)
    assert torch.equal(a, b)
    assert native.launch_counts == before
    with pytest.raises(TypeError):
        tsplat.window_read_codes(img.float(), off, radius=r)
    with pytest.raises(ValueError):
        tsplat.window_read_codes(img.expand(2, -1, -1, -1), off[:, 1:], radius=r)
