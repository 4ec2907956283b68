"""Roofline accounting for measured phases (port of
``cilantro_tpu/utils/roofline.py``).

Turns (seconds, useful operations, bytes moved, indexed rows) into one
line: achieved TFLOP/s as a share of the peak for the operands' type,
achieved GB/s as a share of device memory's rate, the time per row for
latency-bound indexed ops, and which of the three bounds binds.

The default peaks are the published figures of one NVIDIA H100 SXM at its
700 W power limit (dense rates, no sparsity): 67 TFLOP/s float32 off the
tensor cores, 495 TFLOP/s TF32, 989 TFLOP/s bf16, and 3.35 TB/s of HBM3.
A card set below 700 W (``nvidia-smi --query-gpu=power.limit``) runs
slower under load, so state its limit beside any share. Other devices
pass their own peaks.

A row whose achieved compute AND bandwidth are both a few % of peak is
latency-bound (descriptor-limited gathers/scatters): its per-row ns is the
number that matters, not the roofline.
"""

from __future__ import annotations

H100_PEAK_F32 = 67e12  # FLOP/s, float32 off the tensor cores
H100_PEAK_TF32 = 495e12  # FLOP/s, TF32 tensor cores
H100_PEAK_BF16 = 989e12  # FLOP/s, bf16 tensor cores, f32 accumulate
H100_HBM = 3.35e12  # bytes/s, HBM3


def roofline(
    label: str,
    seconds: float,
    *,
    flops: float = 0.0,
    bytes_moved: float = 0.0,
    rows: float = 0.0,
    dtype: str = "f32",
    peak_f32: float = H100_PEAK_F32,
    peak_tf32: float = H100_PEAK_TF32,
    peak_bf16: float = H100_PEAK_BF16,
    hbm_bytes_per_s: float = H100_HBM,
) -> str:
    """One roofline line for a measured phase.

    ``flops``: useful arithmetic (for pruned kernels pass the USEFUL work —
    the full-problem equivalent — and say so in the label; the kernel doing
    less work than brute force is the point, not an efficiency loss).
    ``bytes_moved``: device-memory traffic (operands + results, once each).
    ``rows``: indexed rows (gather/scatter descriptors) for latency-bound
    phases. ``dtype`` ("f32", "tf32" or "bf16") picks the peak.
    """
    peak = {"bf16": peak_bf16, "tf32": peak_tf32}.get(dtype, peak_f32)
    parts = []
    comp_frac = mem_frac = 0.0
    if flops > 0:
        tf = flops / seconds / 1e12
        comp_frac = flops / seconds / peak
        parts.append(
            f"{tf:.2f} TFLOP/s = {comp_frac*100:.1f}% of {dtype} peak"
            f" ({peak/1e12:.0f}T)"
        )
    if bytes_moved > 0:
        gbs = bytes_moved / seconds / 1e9
        mem_frac = bytes_moved / seconds / hbm_bytes_per_s
        parts.append(f"{gbs:.1f} GB/s = {mem_frac*100:.1f}% of HBM")
    if rows > 0:
        parts.append(f"{seconds/rows*1e9:.1f} ns/row over {rows/1e6:.2f}M rows")
    if comp_frac > max(mem_frac, 0.10):
        bound = "compute-bound"
    elif mem_frac > 0.10:
        bound = "bandwidth-bound"
    elif rows > 0:
        bound = "latency-bound (indexed-op issue rate is the ceiling)"
    else:
        bound = "below both rooflines (VPU folding / issue-rate limited)"
    return f"    roofline[{label}]: " + "; ".join(parts) + f" -> {bound}"
