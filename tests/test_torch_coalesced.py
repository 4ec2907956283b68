"""The port's ``coalesced_gather`` (``cilantro_tpu_torch/core/coalesced.py``)
against the JAX package's, run in interpret mode on the CPU, on the index
streams of ``tests/test_coalesced.py``.

Both are copies of source rows, so valid rows must agree exactly. JAX
leaves a wildcard's row (index < 0) unspecified; the port defines it as
``src[0]``, the row the plain gathers of the fusion pipeline read.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilantro_tpu.core.coalesced import NSEGB
from cilantro_tpu.core.coalesced import coalesced_gather as j_gather
from cilantro_tpu_torch import native
from cilantro_tpu_torch.core import coalesced as tc

SEG = 8  # rows per TPU segment at width 16
C = 8 * NSEGB * 2  # two TPU grid steps' worth of pool rows
N = SEG * NSEGB


def _stream(kind):
    """``(C, width, idx)`` for one of ``tests/test_coalesced.py``'s streams."""
    rng = np.random.default_rng({"runs": 0, "jitter": 1, "random": 2, "wildcards": 3}.get(kind, 9))
    if kind == "runs":
        return C, 16, (np.arange(N) + 37) % (C - SEG)
    if kind == "jitter":
        return C, 16, np.arange(N) % (C - 16) + rng.integers(0, 3, N)
    if kind == "random":
        return C, 16, rng.integers(0, C, N)
    if kind == "wildcards":
        idx = (np.arange(N) + 11) % (C - SEG)
        idx[rng.random(N) < 0.3] = -1
        return C, 16, idx
    if kind == "boundary":
        idx = np.full(N, C - 1)
        idx[: N // 2] = np.arange(N // 2) % 3
        return C, 16, idx
    if kind == "unpadded":
        return C, 16, (np.arange(N + 123) + 5) % (C - SEG)
    rng = np.random.default_rng(4)
    c8, n8 = 16 * NSEGB * 2, 16 * NSEGB
    idx = (np.arange(n8) + 7) % (c8 - 16)
    idx[rng.random(n8) < 0.05] = -1
    if kind == "width8_jumps":
        idx[rng.random(n8) < 0.02] = rng.integers(0, c8)
    return c8, 8, idx


def _src(c, w, seed=0):
    return np.random.default_rng(seed).standard_normal((c, w)).astype(np.float32)


@pytest.mark.parametrize(
    "kind",
    ["runs", "jitter", "random", "wildcards", "boundary", "unpadded", "width8", "width8_jumps"],
)
def test_gather_matches_jax_kernel(kind):
    c, w, idx = _stream(kind)
    src = _src(c, w)
    idx = idx.astype(np.int32)
    want = np.asarray(j_gather(jnp.asarray(src), jnp.asarray(idx), interpret=True))
    got = tc.coalesced_gather(torch.from_numpy(src), torch.from_numpy(idx)).numpy()
    valid = idx >= 0
    np.testing.assert_array_equal(got[valid], want[valid])
    np.testing.assert_array_equal(got[~valid], np.broadcast_to(src[0], got[~valid].shape))
    np.testing.assert_array_equal(
        got, tc.coalesced_gather_plain(torch.from_numpy(src), torch.from_numpy(idx)).numpy()
    )


@pytest.mark.parametrize("c,w", [(8, 16), (8, 8), (16, 16), (256, 3)])
def test_tiny_pools_and_odd_width_match_jax(c, w):
    """Pools too small for the TPU window and a width outside {8, 16} take
    JAX's plain gather; the port's result is the same."""
    rng = np.random.default_rng(6)
    src = _src(c, w, seed=5)
    idx = rng.integers(0, c, 300).astype(np.int32)
    want = np.asarray(j_gather(jnp.asarray(src), jnp.asarray(idx), interpret=True))
    got = tc.coalesced_gather(torch.from_numpy(src), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)


def test_out_of_range_indices_clamp():
    """Indices below 0 read row 0 and indices at or above C read row C-1
    (the port's definition; the plain gather of the same clamped stream)."""
    src = _src(40, 16)
    idx = np.array([-5, -1, 0, 39, 40, 1000, 7], np.int32)
    got = tc.coalesced_gather(torch.from_numpy(src), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, src[np.clip(idx, 0, 39)])
    empty = tc.coalesced_gather(torch.from_numpy(src), torch.zeros(0, dtype=torch.int32))
    assert tuple(empty.shape) == (0, 16)


def test_cpu_gather_launches_nothing_and_checks_idx():
    src = torch.from_numpy(_src(64, 16))
    before = native.launch_counts["coalesced_gather"]
    tc.coalesced_gather(src, torch.arange(10, dtype=torch.int32))
    assert native.launch_counts["coalesced_gather"] == before
    with pytest.raises(TypeError, match="dtype"):
        tc.coalesced_gather(src, torch.arange(10))


def test_cuda_path_refuses_what_the_kernel_cannot_index(monkeypatch):
    """Past 2^31 float4s of output, or 2^31 elements of source, the CUDA
    path raises before it allocates or launches (the kernel's offsets are
    32-bit). CPU tensors are sent down that path here; expanded views give
    the sizes without the memory."""
    monkeypatch.setattr(tc.native, "on_cpu", lambda name, *tensors: False)
    before = native.launch_counts["coalesced_gather"]
    with pytest.raises(ValueError, match=r"2\^31 float4s or more"):
        tc.coalesced_gather(torch.zeros(4, 16), torch.zeros(1, dtype=torch.int32).expand(2**29))
    with pytest.raises(ValueError, match=r"2\^31 float4s or more"):
        tc.coalesced_gather(torch.zeros(4, 8), torch.zeros(1, dtype=torch.int32).expand(2**30))
    with pytest.raises(ValueError, match=r"src has 2\^31 elements or more"):
        tc.coalesced_gather(torch.zeros(1, 16).expand(2**27, 16), torch.zeros(3, dtype=torch.int32))
    assert native.launch_counts["coalesced_gather"] == before

