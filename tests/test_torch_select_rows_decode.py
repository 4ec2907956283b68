"""The address arithmetic of the CUDA ``flow_select_rows`` kernel, in plain
PyTorch (no JAX, no card).

A thread of the kernel owns ``PIX`` horizontally adjacent pixels of one
row. It range-checks each pixel's code (an unsigned compare against
``L·(2R+1)²``), looks up the code's source offset
``l·C·plane + (2R − oc / (2R+1))·wp + (2R − oc % (2R+1))`` in a table
(or computes it by divisions when the table would be too large), adds the
pixel's own padded position, and copies C channels ``plane`` apart; where
``W`` is a multiple of ``PIX`` it loads the codes and stores each channel
as one ``PIX``-word vector, otherwise word by word up to ``W``. A model of
those steps must give ``flow_select_rows_plain`` bit for bit, write every
output word exactly once, and keep every vector access aligned.
"""

import numpy as np
import pytest
import torch

from cilantro_tpu_torch.slam import splat

PIX = 2  # kSelectPix in csrc/splat_kernels.cu
GROUP = 16  # kSelectGroup: channels in registers, generic instance
UNWRITTEN = 0x7FC0DEAD  # a NaN pattern that no case's rows hold


def code_table(layers: int, c: int, r: int, hp: int, wp: int) -> torch.Tensor:
    """The table a block builds: the source offset of every in-range code."""
    w2 = 2 * r + 1
    cd = torch.arange(layers * w2 * w2)
    l, oc = cd % layers, cd // layers
    return l * c * hp * wp + (2 * r - oc // w2) * wp + (2 * r - oc % w2)


def kernel_model(rows: torch.Tensor, code: torch.Tensor, r: int, by_table: bool = True):
    """The kernel's loads and stores, thread by thread; returns the output
    and the number of times each output word was written."""
    b, layers, c, hp, wp = rows.shape
    h, w = hp - 2 * r, wp - 2 * r
    hw, plane = h * w, hp * wp
    n_codes = layers * (2 * r + 1) ** 2
    broadcast = b > 1 and rows.stride(0) == 0
    bstride = 0 if broadcast else layers * c * plane
    words = (rows[0] if broadcast else rows).contiguous().view(torch.int32).reshape(-1)
    codes = code.contiguous().reshape(-1)
    vec = w % PIX == 0
    # One entry a (thread, pixel of the thread): batch, row, first column, j.
    bi, y, qx, j = torch.meshgrid(torch.arange(b), torch.arange(h),
                                  torch.arange(-(-w // PIX)), torch.arange(PIX), indexing="ij")
    x0 = qx * PIX
    pix = bi * hw + y * w + x0
    if vec:
        assert bool((pix % PIX == 0).all())  # the code vector's alignment
    live = x0 + j < w
    bi, y, x0, j, pix = (t[live] for t in (bi, y, x0, j, pix))
    cd = codes[pix + j]
    ok = (cd.to(torch.int64) & 0xFFFFFFFF) < n_codes  # the unsigned compare
    safe = torch.where(ok, cd, 0).to(torch.int64)
    if by_table:
        at = code_table(layers, c, r, hp, wp)[safe]
    else:
        l, oc = safe % layers, safe // layers
        at = l * c * plane + (2 * r - oc // (2 * r + 1)) * wp + (2 * r - oc % (2 * r + 1))
    src = bi * bstride + y * wp + x0 + at + j
    dst0 = bi * c * hw + y * w + x0
    out = torch.full((b * c * hw,), UNWRITTEN, dtype=torch.int32)
    writes = torch.zeros(b * c * hw, dtype=torch.int32)
    for c0 in range(0, c, GROUP):
        for ch in range(c0, min(c, c0 + GROUP)):
            dst = dst0 + ch * hw
            if vec:
                assert bool((dst % PIX == 0).all())  # the store vector's alignment
            val = torch.where(ok, words[torch.where(ok, src + ch * plane, 0)], 0)
            out[dst + j] = val
            writes.index_add_(0, dst + j, torch.ones_like(dst, dtype=torch.int32))
    return out.reshape(b, c, h, w), writes


def select_rows_case(kind: str, batch: str, r: int, c: int, w: int, h: int = 9,
                     layers: int = 2, seed: int = 0):
    """Rows of ``c`` channels and codes of one kind: ``random`` (uniform
    over the codes and -1, reaching into the pad near the border), ``all
    -1``, ``out of range`` (-1, -5, ``L·(2R+1)²`` and past it, INT32_MAX
    beside codes in range), ``smooth`` (4 × 8 patches of one code, some
    -1: a bounded flow's patches). ``batch`` is ``B=2 broadcast`` (one map
    read by two code images, batch stride 0) or ``B=1 contiguous``."""
    rng = np.random.default_rng(seed)
    w2 = 2 * r + 1
    n_codes = layers * w2 * w2
    b = 2 if batch == "B=2 broadcast" else 1
    shape = (b, h, w)
    if kind == "random":
        cd = rng.integers(-1, n_codes, size=shape)
    elif kind == "all -1":
        cd = np.full(shape, -1)
    elif kind == "out of range":
        cd = rng.choice(np.array([-1, -5, n_codes, n_codes + 7, 2**31 - 1, 0, n_codes - 1]), shape)
        some = rng.random(shape) < 0.3
        cd[some] = rng.integers(0, n_codes, size=int(some.sum()))
    elif kind == "smooth":
        patch = rng.integers(-1, n_codes, size=(b, -(-h // 4), -(-w // 8)))
        cd = np.repeat(np.repeat(patch, 4, axis=1), 8, axis=2)[:, :h, :w]
    else:
        raise ValueError(kind)
    rows = torch.from_numpy(
        rng.standard_normal((1 if b == 2 else b, layers, c, h + 2 * r, w + 2 * r)).astype(np.float32))
    if b == 2:
        rows = rows.expand(2, -1, -1, -1, -1)
    return rows, torch.from_numpy(cd.astype(np.int32))


CODE_KINDS = ("random", "all -1", "out of range", "smooth")
BATCHES = ("B=2 broadcast", "B=1 contiguous")


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("kind", CODE_KINDS)
@pytest.mark.parametrize("w", (80, 81))
@pytest.mark.parametrize("c", (8, 11, 3, 20))
@pytest.mark.parametrize("r", (2, 4, 8))
def test_kernel_model_is_the_plain_select(r, c, w, kind, batch):
    rows, code = select_rows_case(kind, batch, r, c, w)
    got, writes = kernel_model(rows, code, r)
    want = splat.flow_select_rows_plain(rows, code, r).view(torch.int32)
    assert torch.equal(got, want)
    assert bool((writes == 1).all())


@pytest.mark.parametrize("r", (1, 4, 39))
def test_table_is_the_division_decode(r):
    """The table and the division route give every code the same source,
    the plain version's (layer l, row y + R - dv, column x + R - du)."""
    layers, c, h, w = 2, 3, 5, 7
    hp, wp = h + 2 * r, w + 2 * r
    w2 = 2 * r + 1
    cd = torch.arange(layers * w2 * w2)
    l, oc = cd % layers, cd // layers
    dv, du = oc // w2 - r, oc % w2 - r
    want = l * c * hp * wp + (r - dv) * wp + (r - du)
    assert torch.equal(code_table(layers, c, r, hp, wp), want)
    rows, code = select_rows_case("random", "B=1 contiguous", r, c, w, h=h)
    got, _ = kernel_model(rows, code, r, by_table=False)
    assert torch.equal(got, splat.flow_select_rows_plain(rows, code, r).view(torch.int32))
