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


# Rows of a warp tile of the kernel (csrc/gather_kernels.cu) at either width.
TILE = 32


def _runs(n, run, c, gap=1000, start=0):
    """Runs of ``run`` consecutive indices, each ``gap`` apart in ``src``."""
    i = np.arange(n)
    return (start + (i // run) * gap + i % run) % c


@pytest.mark.cuda
@pytest.mark.parametrize("width", [8, 16])
@pytest.mark.parametrize("big", [False, True])
def test_kernel_tile_edges(cuda, width, big):
    """N at, below and above multiples of the tile and of a block's tiles,
    N = 1, and runs that start mid-tile and cross tile, block and warp
    boundaries, whole or broken by wildcards; in a small stream (one warp a
    tile) and past a million float4s (the resident blocks walk the
    tiles)."""
    c = 20_000
    src = _src(c, width, cuda, seed=width + 1)
    tile = TILE
    base = 2_000_000 // width * 4 if big else 0
    for n in (1, 2, tile - 1, tile, tile + 1, 2 * tile - 1, 3 * tile + 5, 8 * tile - 1, 8 * tile + 1):
        _gather(src, _idx((np.arange(base + n) * 7 + 3) % c, cuda))
    n = base + 40 * tile + 11
    for run, start in ((50, 20), (tile + 3, 5), (33, 31), (tile // 2, tile // 4)):
        _gather(src, _idx(_runs(n, run, c, start=start), cuda))
    broken = _runs(n, tile + 3, c, start=9)
    broken[::37] = -1
    broken[tile - 1::tile] = -7  # a wildcard at the last row of every tile
    _gather(src, _idx(broken, cuda))
    _gather(src, _idx(np.arange(n) % c, cuda))  # one run over every tile


@pytest.mark.cuda
@pytest.mark.parametrize("width", [8, 16])
def test_kernel_clamps_every_index(cuda, width):
    """All wildcards, C = 1, and indices of INT32_MIN and INT32_MAX among
    valid ones: the clamp reads row 0 or row C-1."""
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    for n in (5 * TILE + 3, 400_003):
        src = _src(300, width, cuda, seed=3)
        out = _gather(src, _idx(np.full(n, -1), cuda))
        assert torch.equal(out, src[:1].expand(n, -1))
        out = _gather(src, _idx(np.full(n, lo), cuda))
        assert torch.equal(out, src[:1].expand(n, -1))
        out = _gather(src, _idx(np.full(n, hi), cuda))
        assert torch.equal(out, src[-1:].expand(n, -1))
        mixed = np.arange(n) % 300
        mixed[::3], mixed[1::5] = lo, hi
        _gather(src, _idx(mixed, cuda))
        one = _src(1, width, cuda, seed=4)
        for stream in ([0], [lo, hi, -1, 0, 1, 2], np.arange(n) - n // 2):
            out = _gather(one, _idx(stream, cuda))
            assert torch.equal(out, one.expand(len(stream), -1))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [8, 16])
@pytest.mark.parametrize("n", [650_001, 4_000_037])
def test_kernel_walks_several_tiles(cuda, width, n):
    """N of 2-4 rounds of the resident blocks (each warp walks several
    tiles) and past that (one warp a tile): runs, random rows and 5%
    wildcards."""
    rng = np.random.default_rng(width + 7)
    c = 1_500_000
    src = _src(c, width, cuda, seed=5)
    runs = _runs(n, 600, c, gap=611, start=13)
    runs[rng.random(n) < 0.05] = -1
    _gather(src, _idx(runs, cuda))
    _gather(src, _idx(rng.integers(0, c, n), cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [8, 16])
def test_kernel_reads_an_offset_view(cuda, width):
    """``src`` a 16-byte-aligned view at a nonzero offset: rows off the
    64-byte grid, runs and random rows, small and large streams."""
    rng = np.random.default_rng(width + 11)
    c = 10_000
    flat = _src(c + 2, width, cuda, seed=6).view(-1)
    for offset in (4, 8, 12):  # 16, 32 and 48 bytes
        src = flat[offset:offset + c * width].view(c, width)
        assert src.data_ptr() % 16 == 0 and src.data_ptr() % 64 != 0
        for n in (9 * TILE + 7, 300_007):
            _gather(src, _idx(_runs(n, 70, c, start=1), cuda))
            _gather(src, _idx(rng.integers(-3, c + 3, n), cuda))


@pytest.mark.cuda
def test_launcher_refuses_what_it_cannot_index(cuda):
    """The C launcher refuses, without launching, a width other than 8 or 16
    and 2^31 float4s or more of output or source (its offsets are 32-bit)."""
    lib = tc._kernels()
    stream = torch.cuda.current_stream().cuda_stream
    invalid = 1  # cudaErrorInvalidValue
    assert lib.coalesced_gather_launch(0, 0, 0, 10, 12, 5, stream) == invalid
    assert lib.coalesced_gather_launch(0, 0, 0, 10, 16, 2**29, stream) == invalid
    assert lib.coalesced_gather_launch(0, 0, 0, 10, 8, 2**30, stream) == invalid
    assert lib.coalesced_gather_launch(0, 0, 0, 2**29, 16, 5, stream) == invalid
    assert lib.coalesced_gather_launch(0, 0, 0, 0, 16, 5, stream) == invalid
    assert lib.coalesced_gather_launch(0, 0, 0, 10, 16, 0, stream) == 0
    torch.cuda.synchronize()


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
