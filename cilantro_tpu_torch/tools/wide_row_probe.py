"""Wide-row pool operations against the per-row operations they would
replace, at the pool pipeline's shapes (port of ``tools/wide_row_probe.py``).

    python -m cilantro_tpu_torch.tools.wide_row_probe

On one CUDA card it times, with PyTorch ops and CUDA events (mean over 8
launches after a warm-up), a narrow gather of N = 307,200 pool rows of 64
bytes, the same rows as (CAP/8, 128) tiles of 512 bytes and as two-tile
windows, the 16-way select realignment, a narrow row scatter, a wide tile
scatter, a 1-channel int scatter and a z-buffer-style scatter-min of CAP =
430,080 keys into N pixels; then the :func:`scale2` kernel (the
counterpart of the TPU probe's ``copy_kernel``, ``o = 2·x`` over the
(CAP/8, 128) pool view) beside its plain version and its byte bound. The
index streams are aligned 8-row runs, as the pool's are.

:func:`scale2` launches ``csrc/probe_kernels.cu`` for a CUDA tensor (one
thread per float4 over a full grid, streaming loads; bound by bytes: each
element read and written once) and runs its plain version ``2.0 * x`` for
a CPU tensor. Importing this module runs nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native

H, W = 480, 640
HW = H * W
CAP = int(1.4 * HW)  # 430,080 pool rows
N = HW  # rows gathered per frame
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate


def scale2_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`scale2`."""
    return 2.0 * x


def scale2(x: torch.Tensor) -> torch.Tensor:
    """``2·x`` of a float32 tensor whose size is a multiple of 4."""
    name = "scale2"
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: x has dtype {x.dtype}, wants float32")
    if native.on_cpu(name, x):
        return scale2_plain(x)
    if not x.is_contiguous() or x.data_ptr() % 16 or x.numel() % 4:
        raise ValueError(f"{name}: x must be contiguous, 16-byte aligned and of a size divisible by 4")
    out = torch.empty_like(x)
    native.launch("scale2_launch", x.data_ptr(), out.data_ptr(), x.numel())
    return out


def _ms(fn, iters: int = 8) -> float:
    """Mean device ms of ``fn`` over ``iters`` launches after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    from .. import resolve_device

    dev = resolve_device("cuda")
    print("device:", torch.cuda.get_device_name(dev), flush=True)
    rng = np.random.default_rng(0)
    pool = torch.from_numpy(rng.standard_normal((CAP, 16)).astype(np.float32)).to(dev)
    pool128 = pool.reshape(CAP // 8, 128)

    # Run-structured narrow indices: aligned 8-row runs.
    nseg = N // 8
    starts = np.maximum(0, np.minimum(CAP // 8 - 9, np.sort(rng.integers(0, CAP // 8, nseg))))
    base = torch.from_numpy(starts.astype(np.int64)).to(dev)
    idx = (base[:, None] * 8 + torch.arange(8, device=dev)).reshape(-1)

    def line(what, ms, rows=N):
        print(f"{what:<40s} {ms:8.4f} ms ({ms * 1e6 / rows:6.2f} ns/row)", flush=True)

    line(f"narrow gather {N} rows x 64B", _ms(lambda: pool[idx]))
    line(f"wide gather {nseg} tiles x 512B", _ms(lambda: pool128[base]))
    win = torch.stack([base, base + 1], dim=1)
    line(f"wide window gather {nseg}x2 tiles", _ms(lambda: pool128[win]))

    code = torch.from_numpy(rng.integers(0, 16, (nseg, 8))).to(dev)
    wins = torch.from_numpy(rng.standard_normal((nseg, 256)).astype(np.float32)).to(dev)

    def realign():
        w16 = wins.reshape(nseg, 16, 16)
        out = torch.zeros((nseg, 8, 16), device=dev)
        for d in range(16):
            out = out + torch.where((code == d)[..., None], w16[:, d][:, None, :], 0.0)
        return out

    line(f"16-way select realign {nseg} segs", _ms(realign))

    rows = torch.from_numpy(rng.standard_normal((N, 16)).astype(np.float32)).to(dev)
    line(f"narrow row scatter {N} x 64B", _ms(lambda: pool.clone().index_copy_(0, idx, rows)))
    rows128 = rows.reshape(nseg, 128)
    line(f"wide tile scatter {nseg} x 512B", _ms(lambda: pool128.clone().index_copy_(0, base, rows128)))
    vals = torch.arange(N, dtype=torch.int32, device=dev)
    line(f"1ch int scatter {N}", _ms(lambda: torch.full((CAP,), -1, dtype=torch.int32, device=dev)
                                     .index_copy_(0, idx, vals)))
    keys = torch.from_numpy(rng.integers(0, 2**30, CAP).astype(np.int32)).to(dev)
    tgt = torch.from_numpy(rng.integers(0, HW, CAP)).to(dev)
    line(f"scatter-min {CAP} keys -> {HW}", _ms(lambda: torch.full((HW,), 2**31 - 1, dtype=torch.int32,
                                                                   device=dev).scatter_reduce_(0, tgt, keys, "amin")),
         rows=CAP)

    # The TPU probe's copy kernel: o = 2·x over the (CAP/8, 128) view.
    out = scale2(pool128)
    torch.cuda.synchronize()
    same = torch.equal(out.view(torch.int32), scale2_plain(pool128).view(torch.int32))
    bound = 2 * pool128.numel() * 4 / HBM_BYTES_PER_S * 1e3
    print(f"scale2 kernel {tuple(pool128.shape)}: {_ms(lambda: scale2(pool128)):.4f} ms, "
          f"plain {_ms(lambda: scale2_plain(pool128)):.4f} ms, byte bound {bound:.4f} ms, "
          f"bit-exact {same}", flush=True)


if __name__ == "__main__":
    main()
