"""Wide-row gather (port of ``cilantro_tpu/core/coalesced.py``).

:func:`coalesced_gather` computes ``src[idx]`` for pool rows of 8 or 16
float32 with ``idx`` clamped into ``[0, C)``: an index below 0 (a
wildcard, which fusion passes for "no row here") reads row 0 and an index
at or above ``C`` reads row ``C - 1``. Those are the rows the JAX
package's plain gathers read, so the kernel and its plain version agree
with ``src[idx.clamp(0, C-1)]`` bit for bit on every row, and a caller's
result does not depend on whether it went through the kernel.

The CUDA kernel (``csrc/gather_kernels.cu``, built for ``sm_90a`` at first
CUDA use) takes float32 rows of width 8 or 16, any ``C ≥ 1``, and fewer
than 2^31 float4s of source and of output, since its offsets are 32-bit;
its launcher refuses more, and the wrapper raises first (for a ``src`` of
2^31 elements or more, and for 2^31 float4s or more of output). A CUDA
``src`` of another width or dtype raises. CPU tensors of any width
or dtype take the plain version. The TPU kernel's coalescing plan, window
fetch and one-hot realignment answered a per-row DMA cost the card does
not have (see the kernel source) and are not ported. Every launch adds one
to ``launch_counts["coalesced_gather"]``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from .. import native

KERNEL_WIDTHS = (8, 16)

launch_counts: Dict[str, int] = {"coalesced_gather": 0}


def reset_launch_counts() -> None:
    launch_counts["coalesced_gather"] = 0


@functools.cache
def _kernels() -> ctypes.CDLL:
    lib = native.load("gather_kernels")
    fn = lib.coalesced_gather_launch
    fn.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
    fn.restype = ctypes.c_int
    return lib


def coalesced_gather_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`coalesced_gather`."""
    return src[idx.clamp(0, src.shape[0] - 1).long()]


def coalesced_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[clamp(idx, 0, C-1)]`` for ``src (C, w)`` and ``idx (N,)`` int32
    on one device: ``(N, w)``. On CUDA ``src`` must be float32 rows of
    width 8 or 16; CPU tensors take the plain version."""
    name = "coalesced_gather"
    c, w = src.shape
    n = idx.shape[0]
    native.check(name, idx, "idx", (torch.int32,), (n,))
    if c < 1:
        raise ValueError(f"{name}: src has no rows")
    if native.on_cpu(name, src, idx):
        return coalesced_gather_plain(src, idx)
    native.check(name, src, "src", (torch.float32,), (c, w))
    if w not in KERNEL_WIDTHS:
        raise ValueError(f"{name}: src rows are {w} wide, the kernel takes {KERNEL_WIDTHS}")
    if n * (w // 4) >= 2**31:  # check() keeps src under 2^31 elements, 2^29 float4s
        raise ValueError(f"{name}: {n} output rows of {w} are 2^31 float4s or more, the kernel's limit")
    if not (src.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: src and idx must be contiguous")
    if src.data_ptr() % 16:
        raise ValueError(f"{name}: src must be 16-byte aligned")
    out = torch.empty((n, w), dtype=torch.float32, device=src.device)
    if n == 0:
        return out
    err = _kernels().coalesced_gather_launch(
        src.data_ptr(), idx.data_ptr(), out.data_ptr(), c, w, n,
        torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    launch_counts[name] += 1
    return out
