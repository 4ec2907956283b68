"""The CUDA ``coalesced_gather`` kernel against its plain PyTorch version,
and a pool fusion step on the card against the CPU.

The kernel copies source rows, so it must equal ``src[idx.clamp(0, C-1)]``
bit for bit on every row (compared as int32 views). The fusion step's
pose and pool may differ from the CPU run by float32 roundoff only: 1e-5.
The tests skip on a machine without a CUDA device. This file imports
neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_coalesced_cuda.py
"""

import numpy as np
import pytest
import torch

from cilantro_tpu_torch.core import coalesced as tc


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _gather(src, idx, launches=1):
    """Kernel output for ``(src, idx)``, checked bit for bit against the
    plain version and for the number of kernel launches it made."""
    before = tc.launch_counts["coalesced_gather"]
    out = tc.coalesced_gather(src, idx)
    torch.cuda.synchronize()
    assert tc.launch_counts["coalesced_gather"] - before == launches
    want = tc.coalesced_gather_plain(src, idx)
    assert out.shape == want.shape
    assert torch.equal(out.cpu().view(torch.int32), want.cpu().view(torch.int32))
    return out


def _src(c, w, dev, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((c, w)).astype(np.float32)).to(dev)


def _idx(a, dev):
    return torch.from_numpy(np.asarray(a, np.int32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [8, 16])
def test_kernel_matches_plain_on_fusion_like_streams(cuda, width):
    rng = np.random.default_rng(width)
    c, n = 50_000, 30_011  # n is not a multiple of the block
    src = _src(c, width, cuda)
    runs = (np.arange(n) + 123) % c
    wild = runs.copy()
    wild[rng.random(n) < 0.3] = -1
    for stream in (runs, wild, rng.integers(0, c, n), rng.integers(-5, c + 5, n)):
        _gather(src, _idx(stream, cuda))


@pytest.mark.cuda
def test_kernel_edge_shapes(cuda):
    for c in (1, 2):
        src = _src(c, 16, cuda, seed=c)
        _gather(src, _idx([-3, 0, 1, 2, 7, -1, 1], cuda))
    src = _src(300, 8, cuda)
    assert _gather(src, _idx([], cuda), launches=0).shape == (0, 8)
    _gather(src, _idx([299], cuda))
    _gather(src, _idx(np.arange(1000) % 300, cuda))
    out = _gather(src, _idx(np.full(777, -1), cuda))  # all wildcards: row 0
    assert torch.equal(out, src[:1].expand(777, -1))
    out = _gather(src, _idx(np.full(65, 300 + 9), cuda))  # all past the end: row C-1
    assert torch.equal(out, src[-1:].expand(65, -1))


@pytest.mark.cuda
def test_other_widths_and_dtypes_raise(cuda):
    idx = _idx(np.arange(64) - 3, cuda)
    before = tc.launch_counts["coalesced_gather"]
    with pytest.raises(ValueError, match="wide"):
        tc.coalesced_gather(_src(256, 3, cuda), idx)
    with pytest.raises(TypeError, match="dtype"):
        tc.coalesced_gather(_src(256, 16, cuda).double(), idx)
    assert tc.launch_counts["coalesced_gather"] == before


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda):
    src = _src(256, 16, cuda)
    with pytest.raises(TypeError, match="dtype"):
        tc.coalesced_gather(src, torch.arange(8, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        tc.coalesced_gather(_src(256, 32, cuda)[:, ::2], _idx([1, 2], cuda))
    with pytest.raises(ValueError, match="several devices"):
        tc.coalesced_gather(src, _idx([1, 2], "cpu"))


@pytest.mark.cuda
def test_fusion_step_on_card_matches_cpu(cuda):
    from cilantro_tpu_torch.core.rgbd import CameraIntrinsics, depth_to_points_normals
    from cilantro_tpu_torch.core.transforms import identity
    from cilantro_tpu_torch.slam import fusion

    h, w = 48, 64
    k = CameraIntrinsics.make(100.0, 100.0, 31.5, 23.5)
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    depths = [
        (1.5 + 0.05 * np.sin(0.2 * u + p) + 0.05 * np.cos(0.15 * v)).astype(np.float32)
        for p in (0.0, 0.2)
    ]
    cfg = fusion.FusionConfig()
    out = {}
    for dev in (cuda, torch.device("cpu")):
        f0, f1 = (depth_to_points_normals(torch.from_numpy(d).to(dev), k) for d in depths)
        fmap = fusion.init_map_from_frame(2 * h * w, f0[0], f0[1], None, f0[2])
        before = tc.launch_counts["coalesced_gather"]
        fmap, pose, res, imap, packed = fusion.fusion_step(
            fmap, f1[0], f1[1], None, f1[2], identity(3, device=dev), k,
            height=h, width=w, cfg=cfg,
        )
        launched = tc.launch_counts["coalesced_gather"] - before
        out[dev.type] = (fmap.data.cpu(), pose.matrix().cpu(), launched, int(res.iterations))
    (d_g, p_g, l_g, it_g), (d_c, p_c, l_c, it_c) = out["cuda"], out["cpu"]
    assert l_c == 0 and l_g == 2 + it_g  # integrate's two gathers and one per ICP iteration
    assert it_g == it_c
    assert torch.allclose(p_g, p_c, rtol=0, atol=1e-5)
    assert torch.equal(d_g[:, 10] > 0.5, d_c[:, 10] > 0.5)
    assert torch.allclose(d_g, d_c, rtol=0, atol=1e-5)
