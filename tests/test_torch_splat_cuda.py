"""Each CUDA splat kernel against its plain PyTorch version, on the card.

The kernels are pure selects: outputs must agree bit for bit (floats
compared as int32 views). The tests skip on a machine without a CUDA
device. This file imports neither JAX nor the JAX package, so it also runs
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_splat_cuda.py
"""

import numpy as np
import pytest
import torch

from cilantro_tpu_torch import native
from cilantro_tpu_torch.slam import splat
from test_torch_argmin2_election import edge_case_inputs
from test_torch_select_rows_decode import BATCHES, CODE_KINDS, PIX, select_rows_case

LAYERS, H, W = 2, 64, 80


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.cpu().contiguous().view(torch.int32).numpy()


def _launched(name, fn):
    """Run ``fn`` and check that it launched kernel ``name`` exactly once."""
    before = native.launch_counts[name]
    out = fn()
    torch.cuda.synchronize()
    assert native.launch_counts[name] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("r", (2, 4))
def test_cuda_argmin2_matches_plain(r, cuda):
    rng = np.random.default_rng(r)
    w2 = 2 * r + 1
    key = rng.random((1, LAYERS, H + 2 * r, W + 2 * r)).astype(np.float32)
    key[rng.random(key.shape) < 0.2] = 0.5  # ties: the tie order matters
    off = rng.integers(-1, w2 * w2, size=key.shape).astype(np.int32)
    key[off < 0] = np.inf
    key_t, off_t = torch.from_numpy(key), torch.from_numpy(off)
    plain = splat.splat_argmin2(key_t, off_t, radius=r)
    dev = _launched(
        "splat_argmin2",
        lambda: splat.splat_argmin2(key_t.to(cuda), off_t.to(cuda), radius=r),
    )
    for p, d in zip(plain, dev):
        np.testing.assert_array_equal(_bits(d), _bits(p))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("kind", CODE_KINDS)
@pytest.mark.parametrize("w", (80, 81))
@pytest.mark.parametrize("c", (8, 11, 3, 20))
@pytest.mark.parametrize("r", (2, 4, 8))
def test_cuda_select_rows_matches_plain(r, c, w, kind, batch, cuda):
    """The 8- and 11-channel instances and the generic one (3 channels; 20
    in two groups), the vector (W = 80) and scalar (W = 81) routes, codes
    random, all -1, out of range and in smooth patches, a broadcast map
    read by two code images and one contiguous map."""
    rows, code = select_rows_case(kind, batch, r, c, w, h=H)
    dev = _select_rows_on_card(rows, code.to(cuda), r, cuda)
    np.testing.assert_array_equal(_bits(dev), _bits(splat.flow_select_rows(rows, code, radius=r)))
    design = splat.kernel_design["flow_select_rows"]
    assert design["store_bytes"] == (4 * PIX if w % PIX == 0 else 4)
    assert design["channel_instance"] == (c if c in (8, 11) else "generic")
    assert design["decode"] == "table"


def _select_rows_on_card(rows, code_d, r, cuda):
    """Kernel output of ``rows`` (moved to the card; a broadcast map stays
    one) and codes already on the card."""
    rows_d = rows[:1].to(cuda).expand(2, -1, -1, -1, -1) if rows.shape[0] == 2 else rows.to(cuda)
    return _launched("flow_select_rows", lambda: splat.flow_select_rows(rows_d, code_d, radius=r))


@pytest.mark.cuda
def test_cuda_select_rows_unaligned_codes(cuda):
    """Codes one word past a 16-byte boundary take the scalar route."""
    r = 4
    rows, code = select_rows_case("random", "B=1 contiguous", r, 8, 80, h=H)
    buf = torch.zeros(code.numel() + 1, dtype=torch.int32, device=cuda)
    buf[1:] = code.reshape(-1).to(cuda)
    code_d = buf[1:].view(code.shape)
    assert code_d.data_ptr() % 16 == 4
    dev = _select_rows_on_card(rows, code_d, r, cuda)
    np.testing.assert_array_equal(_bits(dev), _bits(splat.flow_select_rows(rows, code, radius=r)))
    assert splat.kernel_design["flow_select_rows"]["store_bytes"] == 4


@pytest.mark.cuda
def test_cuda_select_rows_division_decode(cuda):
    """A table past 12,288 codes (L = 2, R = 39) is decoded by divisions."""
    r = 39
    rows, code = select_rows_case("smooth", "B=2 broadcast", r, 3, 16, h=12)
    dev = _select_rows_on_card(rows, code.to(cuda), r, cuda)
    np.testing.assert_array_equal(_bits(dev), _bits(splat.flow_select_rows(rows, code, radius=r)))
    assert splat.kernel_design["flow_select_rows"]["decode"] == "divisions"


@pytest.mark.cuda
@pytest.mark.parametrize("r", (2, 4))
def test_cuda_window_read_matches_plain(r, cuda):
    """One frame broadcast to both layers (batch stride 0)."""
    rng = np.random.default_rng(r)
    w2 = 2 * r + 1
    img = torch.from_numpy(
        rng.integers(-1000, 1000, size=(1, 7, H + 2 * r, W + 2 * r)).astype(np.int32)
    )
    off = torch.from_numpy(rng.integers(-1, w2 * w2, size=(LAYERS, H, W)).astype(np.int32))
    plain = splat.window_read_codes(img.expand(LAYERS, -1, -1, -1), off, radius=r)
    dev = _launched(
        "window_read_codes",
        lambda: splat.window_read_codes(
            img.to(cuda).expand(LAYERS, -1, -1, -1), off.to(cuda), radius=r
        ),
    )
    np.testing.assert_array_equal(dev.cpu().numpy(), plain.numpy())


@pytest.mark.cuda
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    r = 2
    off = torch.zeros((1, H, W), dtype=torch.int32, device=cuda)
    img = torch.zeros((1, 2, H + 2 * r, W + 2 * r), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="several devices"):
        splat.window_read_codes(img, off.cpu(), radius=r)
    with pytest.raises(ValueError, match="contiguous"):
        splat.window_read_codes(img.transpose(2, 3).contiguous().transpose(2, 3), off, radius=r)


@pytest.mark.cuda
@pytest.mark.parametrize("r", (2, 4))
@pytest.mark.parametrize("hw", ((37, 101), (16, 64), (130, 70)))
def test_cuda_argmin2_edge_cases_match_plain(r, hw, cuda):
    """Two frames of two layers; ties, signed zeros, NaN and +inf keys,
    codes out of range, pad sources; frames cut by the tile and not."""
    key, off = edge_case_inputs(r + hw[0], r, h=hw[0], w=hw[1])
    plain = splat.splat_argmin2_plain(key, off, r)
    dev = _launched(
        "splat_argmin2", lambda: splat.splat_argmin2(key.to(cuda), off.to(cuda), radius=r)
    )
    for p, d in zip(plain, dev):
        np.testing.assert_array_equal(_bits(d), _bits(p))
    design = splat.kernel_design["splat_argmin2"]
    tiles = -(-hw[0] // design["tile_h"]) * -(-hw[1] // design["tile_w"])
    assert design["blocks"] == 2 * tiles
    bk, _, sk, _ = plain
    assert ((bk == 0) & torch.signbit(bk)).any() and (bk == sk).any()
