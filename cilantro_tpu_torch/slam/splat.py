"""Bounded-flow splat kernels (port of ``cilantro_tpu/slam/splat.py``).

Three stencil gathers carry splat fusion's re-association and localize:

- :func:`window_read_codes` — source-aligned window read: each source pixel
  reads the target image at its own decoded offset;
- :func:`splat_argmin2` — per target pixel, the best and second-best
  ``(key, code)`` over the ``L·(2R+1)²`` in-window sources landing on it;
- :func:`flow_select_rows` — rebuild the C-channel row image of the source
  pixel each ``code`` names.

Each is a CUDA C++ kernel (``csrc/splat_kernels.cu``, built for ``sm_90a``
at first CUDA use) with a plain PyTorch version beside it. A wrapper runs
the plain version only when its tensors lie on the CPU; for CUDA tensors it
launches the kernel or raises. Every launch adds one to
``native.launch_counts[<name>]``. Kernel and plain version are pure
selects and agree bit for bit. :func:`splat_argmin2`'s kernel elects each
tile's pairs in shared memory from the sources that land on it (a
lexicographic minimum of ``(key, visit index)``, see the source); the
other two read one source a pixel, :func:`flow_select_rows` two adjacent
pixels a thread through a shared-memory table of each code's source
offset.

Padding convention (the JAX module's): callers pad the last two dims by
``R`` on each side (key=+inf, code/off=-1, rows=0) and pass
``(..., H+2R, W+2R)`` tensors. The TPU wrappers' extra lane/sublane padding
and band-divisibility assert are TPU tiling needs, not part of the
contract: any ``H``, ``W`` work here.

Codes: offset code ``oc = (dv+R)·(2R+1) + (du+R)``; row code ``oc·L + l``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .. import native

# The three kernels' names, as native.launch_counts counts them.
KERNELS = ("window_read_codes", "splat_argmin2", "flow_select_rows")
# The launch parameters of the last launch of splat_argmin2 (the tile of
# target pixels a block elects and the blocks) and of flow_select_rows
# (pixels a thread, decode route, store width, channel instance, blocks).
kernel_design: Dict[str, Dict[str, object]] = {}


def offset_code(du: torch.Tensor, dv: torch.Tensor, radius: int) -> torch.Tensor:
    """Pack an in-window pixel offset into one comparand int (else -1)."""
    w2 = 2 * radius + 1
    ok = (du >= -radius) & (du <= radius) & (dv >= -radius) & (dv <= radius)
    code = (dv + radius) * w2 + (du + radius)
    return torch.where(ok, code, -1).to(torch.int32)


def pad_hw(x: torch.Tensor, radius: int, fill) -> torch.Tensor:
    """Pad the last two dims by ``radius`` with ``fill``."""
    return F.pad(x, (radius, radius, radius, radius), value=fill)


# ---------------------------------------------------------------------------
# Argument checks.
# ---------------------------------------------------------------------------


def _batch_stride(name: str, t: torch.Tensor, what: str) -> int:
    """Batch stride of a tensor whose every batch entry is contiguous; 0
    where one entry is broadcast to the whole batch (``expand``)."""
    if not t[0].is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous past its batch dim")
    stride = t.stride(0) if t.shape[0] > 1 else t[0].numel()
    if stride not in (0, t[0].numel()):
        raise ValueError(f"{name}: {what} batch stride {stride} unsupported")
    return stride


def _contiguous(name: str, *pairs) -> None:
    for what, t in pairs:
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")


# ---------------------------------------------------------------------------
# window_read_codes
# ---------------------------------------------------------------------------


def window_read_codes_plain(
    img: torch.Tensor, off: torch.Tensor, radius: int
) -> torch.Tensor:
    """Plain version of :func:`window_read_codes`."""
    r = radius
    w2 = 2 * r + 1
    b, c, hp, wp = img.shape
    h, w = hp - 2 * r, wp - 2 * r
    ok = (off >= 0) & (off < w2 * w2)
    oc = torch.where(ok, off, r * w2 + r)
    dv, du = oc // w2 - r, oc % w2 - r
    ys = torch.arange(h, device=off.device)[:, None] + r + dv
    xs = torch.arange(w, device=off.device)[None, :] + r + du
    idx = (ys * wp + xs).reshape(b, 1, h * w).expand(b, c, h * w)
    out = torch.gather(img.reshape(b, c, hp * wp), 2, idx).reshape(b, c, h, w)
    return torch.where(ok[:, None], out, -1)


def window_read_codes(
    img: torch.Tensor,  # (B, C, H+2R, W+2R) i32 target-aligned, -1 pad
    off: torch.Tensor,  # (B, H, W) i32 per-SOURCE offset code (-1 = none)
    *,
    radius: int,
) -> torch.Tensor:
    """Source-aligned window read: ``out[b, c, y, x] = img[b, c, y+R+dv,
    x+R+du]`` with (dv, du) decoded from ``off[b, y, x]``; -1 where ``off``
    is outside ``[0, (2R+1)²)``. ``img``'s batch entries may be one
    broadcast frame (``expand``, batch stride 0)."""
    name = "window_read_codes"
    r = radius
    b, c, hp, wp = img.shape
    h, w = hp - 2 * r, wp - 2 * r
    native.check(name, img, "img", (torch.int32,), (b, c, hp, wp))
    native.check(name, off, "off", (torch.int32,), (b, h, w))
    if native.on_cpu(name, img, off):
        return window_read_codes_plain(img, off, r)
    bstride = _batch_stride(name, img, "img")
    _contiguous(name, ("off", off))
    out = torch.empty((b, c, h, w), dtype=torch.int32, device=off.device)
    native.launch(
        "window_read_codes_launch",
        img.data_ptr(), off.data_ptr(), out.data_ptr(), b, c, h, w, r, bstride,
    )
    return out


# ---------------------------------------------------------------------------
# splat_argmin2
# ---------------------------------------------------------------------------


def splat_argmin2_plain(
    key: torch.Tensor, off: torch.Tensor, radius: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`splat_argmin2`: the candidate sweep of the
    TPU kernel, one (layer, dv, du) shift at a time."""
    r = radius
    w2 = 2 * r + 1
    b, layers, hp, wp = key.shape
    h, w = hp - 2 * r, wp - 2 * r
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=key.device)
    best_k = inf.expand(b, h, w).clone()
    sec_k = best_k.clone()
    best_c = torch.full((b, h, w), -1, dtype=torch.int32, device=key.device)
    sec_c = best_c.clone()
    for l in range(layers):
        for dv in range(-r, r + 1):
            for du in range(-r, r + 1):
                oc = (dv + r) * w2 + (du + r)
                code = oc * layers + l
                ys, xs = r - dv, r - du
                k_s = key[:, l, ys : ys + h, xs : xs + w]
                o_s = off[:, l, ys : ys + h, xs : xs + w]
                cand = torch.where(o_s == oc, k_s, inf)
                lt_best = cand < best_k
                lt_sec = cand < sec_k
                sec_k = torch.where(lt_best, best_k, torch.where(lt_sec, cand, sec_k))
                sec_c = torch.where(lt_best, best_c, torch.where(lt_sec, code, sec_c))
                best_k = torch.where(lt_best, cand, best_k)
                best_c = torch.where(lt_best, code, best_c)
    return best_k, best_c, sec_k, sec_c


def splat_argmin2(
    key: torch.Tensor,  # (B, L, H+2R, W+2R) f32, +inf invalid/pad
    off: torch.Tensor,  # (B, L, H+2R, W+2R) i32 offset code, -1 invalid/pad
    *,
    radius: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best/second ``(key, code)`` per output pixel, each ``(B, H, W)``.
    Deterministic ties: the first candidate in (layer, dv, du) order wins on
    equal keys; +inf / -1 where no candidate lands."""
    name = "splat_argmin2"
    r = radius
    b, layers, hp, wp = key.shape
    h, w = hp - 2 * r, wp - 2 * r
    native.check(name, key, "key", (torch.float32,), (b, layers, hp, wp))
    native.check(name, off, "off", (torch.int32,), (b, layers, hp, wp))
    if native.on_cpu(name, key, off):
        return splat_argmin2_plain(key, off, r)
    _contiguous(name, ("key", key), ("off", off))
    dev = key.device
    bk = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    sk = torch.empty_like(bk)
    bc = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    sc = torch.empty_like(bc)
    design = (ctypes.c_int * 3)()
    native.launch(
        "splat_argmin2_launch",
        key.data_ptr(), off.data_ptr(), bk.data_ptr(), bc.data_ptr(),
        sk.data_ptr(), sc.data_ptr(), b, layers, h, w, r, ctypes.addressof(design),
    )
    kernel_design[name] = dict(tile_w=design[0], tile_h=design[1], blocks=design[2])
    return bk, bc, sk, sc


# ---------------------------------------------------------------------------
# flow_select_rows
# ---------------------------------------------------------------------------


def flow_select_rows_plain(
    rows: torch.Tensor, code: torch.Tensor, radius: int
) -> torch.Tensor:
    """Plain version of :func:`flow_select_rows` (selects the 32-bit
    patterns, so any float bits pass through unchanged)."""
    r = radius
    w2 = 2 * r + 1
    b, layers, c, hp, wp = rows.shape
    h, w = hp - 2 * r, wp - 2 * r
    ok = (code >= 0) & (code < layers * w2 * w2)
    cd = torch.where(ok, code, (r * w2 + r) * layers)
    l, oc = cd % layers, cd // layers
    dv, du = oc // w2 - r, oc % w2 - r
    ys = torch.arange(h, device=code.device)[:, None] + r - dv
    xs = torch.arange(w, device=code.device)[None, :] + r - du
    plane = hp * wp
    base = (l * (c * plane) + ys * wp + xs).reshape(b, 1, h * w)
    chan = (torch.arange(c, device=code.device) * plane).reshape(1, c, 1)
    bits = rows.reshape(b, layers * c * plane).view(torch.int32)
    out = torch.gather(bits, 1, (base + chan).reshape(b, c * h * w))
    out = torch.where(ok[:, None], out.reshape(b, c, h, w), 0)
    return out.view(torch.float32)


def flow_select_rows(
    rows: torch.Tensor,  # (B, L, C, H+2R, W+2R) f32, 0 pad
    code: torch.Tensor,  # (B, H, W) i32 winning code per output pixel (-1 none)
    *,
    radius: int,
) -> torch.Tensor:
    """Rebuild the selected row image ``(B, C, H, W)``: ``out[b, :, y, x]``
    is the row of the source pixel that ``code[b, y, x]`` names (zeros
    where the code is outside ``[0, L·(2R+1)²)``). ``rows``' batch entries
    may be one broadcast map (``expand``), so the winner and runner-up
    images come from one launch."""
    name = "flow_select_rows"
    r = radius
    b, layers, c, hp, wp = rows.shape
    h, w = hp - 2 * r, wp - 2 * r
    native.check(name, rows, "rows", (torch.float32,), (b, layers, c, hp, wp))
    native.check(name, code, "code", (torch.int32,), (b, h, w))
    if native.on_cpu(name, rows, code):
        return flow_select_rows_plain(rows, code, r)
    bstride = _batch_stride(name, rows, "rows")
    _contiguous(name, ("code", code))
    out = torch.empty((b, c, h, w), dtype=torch.float32, device=code.device)
    design = (ctypes.c_int * 5)()
    native.launch(
        "flow_select_rows_launch",
        rows.data_ptr(), code.data_ptr(), out.data_ptr(), b, layers, c, h, w, r,
        bstride, ctypes.addressof(design),
    )
    kernel_design[name] = dict(
        pixels_a_thread=design[0], decode="table" if design[1] else "divisions",
        store_bytes=design[2], channel_instance=design[3] or "generic", blocks=design[4],
    )
    return out
