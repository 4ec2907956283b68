"""Time ``flow_select_rows``' and ``scale2``'s kernels beside other designs
and source variants on one CUDA card:

    python3 cilantro_tpu_torch/tools/select_rows_variants.py

Run from the root of a checkout. Builds ``tools/select_rows_alternatives.cu``
(the previous design of each kernel, a shared-memory halo for
``flow_select_rows`` and 1-D bulk copies for ``scale2``) and
``csrc/splat_kernels.cu`` / ``csrc/probe_kernels.cu`` with one constant or
expression changed per variant (pixels a thread, decode route, threads a
block, cache hints, loads in flight) into ``_build/variants/``; a variant
the compiler refuses is reported and left out. Each design is then held
against the plain version bit for bit and timed (``chip_smoke.py``'s
``device_ms``), visiting the designs forward and then backward so that
drift shows: ``flow_select_rows`` on ``chip_smoke.py``'s random codes
(phase 2) and on the last frame of a 16-frame run of splat fusion, then
splat fusion's device ms a frame (``chip_smoke.py``'s profile window) with
the previous design and this one in turns, and ``scale2`` on the probe's (CAP/8, 128) view in phase 20's five pairs
alternating with ``torch.mul(x, 2.0)``, and both with the L2 cleared
before each run. One JSON line a design and case, after one line a
source variant with its kernel's SASS: instructions (and a pixel), LDGs
before the first STG, LDGs and STGs.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent

# Other designs: (kernel, name, function in the alternatives' library).
DESIGNS = (
    ("flow_select_rows", "previous: one thread a pixel, divisions, scalar stores",
     "flow_select_rows_prev_launch"),
    ("flow_select_rows", "shared-memory halo, 32 x 16 tile, 4 channels staged",
     "flow_select_rows_halo_launch"),
    ("scale2", "previous: grid-stride loop, one load in flight", "scale2_prev_launch"),
    ("scale2", "1-D bulk copy (TMA), 16 KB a block", "scale2_bulk16_launch"),
    ("scale2", "1-D bulk copy (TMA), 32 KB a block", "scale2_bulk32_launch"),
)
# Source variants: (kernel, name, source file, {text: replacement}); the
# first of each kernel is the source as it is.
VARIANTS = (
    ("flow_select_rows", "as built: 2 pixels a thread, table, 8-byte streaming stores",
     "splat_kernels", {}),
    ("flow_select_rows", "4 pixels a thread", "splat_kernels",
     {"constexpr int kSelectPix = 2;": "constexpr int kSelectPix = 4;"}),
    ("flow_select_rows", "1 pixel a thread", "splat_kernels",
     {"constexpr int kSelectPix = 2;": "constexpr int kSelectPix = 1;"}),
    ("flow_select_rows", "decode by divisions", "splat_kernels",
     {"constexpr int kMaxTableCodes = 12288;": "constexpr int kMaxTableCodes = 0;"}),
    ("flow_select_rows", "default stores", "splat_kernels",
     {"constexpr bool kStreamStores = true;": "constexpr bool kStreamStores = false;"}),
    ("flow_select_rows", "streaming source loads", "splat_kernels",
     {"? __ldg(base + src[j] + (c0 + c) * plane) : 0u;":
      "? __ldcs(base + src[j] + (c0 + c) * plane) : 0u;"}),
    ("flow_select_rows", "128 threads a block", "splat_kernels",
     {"constexpr int kSelectThreads = 256;": "constexpr int kSelectThreads = 128;"}),
    ("flow_select_rows", "512 threads a block", "splat_kernels",
     {"constexpr int kSelectThreads = 256;": "constexpr int kSelectThreads = 512;"}),
    ("flow_select_rows", "registers for 8 blocks a SM", "splat_kernels",
     {"__global__ void __launch_bounds__(kSelectThreads) flow_select_rows_kernel(":
      "__global__ void __launch_bounds__(kSelectThreads, 2048 / kSelectThreads) "
      "flow_select_rows_kernel("}),
    ("scale2", "as built: 1 load in flight, streaming loads, default stores",
     "probe_kernels", {}),
    ("scale2", "2 loads in flight", "probe_kernels",
     {"constexpr int kUnroll = 1;": "constexpr int kUnroll = 2;"}),
    ("scale2", "4 loads in flight", "probe_kernels",
     {"constexpr int kUnroll = 1;": "constexpr int kUnroll = 4;"}),
    ("scale2", "8 loads in flight", "probe_kernels",
     {"constexpr int kUnroll = 1;": "constexpr int kUnroll = 8;"}),
    ("scale2", "128 threads a block", "probe_kernels",
     {"constexpr int kThreads = 256;": "constexpr int kThreads = 128;"}),
    ("scale2", "read-only loads (ld.global.nc)", "probe_kernels",
     {"{ return __ldcs(p); }": "{ return __ldg(p); }"}),
    ("scale2", "streaming stores", "probe_kernels", {"{ *p = v; }": "{ __stcs(p, v); }"}),
    ("scale2", "read-only loads, streaming stores", "probe_kernels",
     {"{ return __ldcs(p); }": "{ return __ldg(p); }", "{ *p = v; }": "{ __stcs(p, v); }"}),
    ("scale2", "loads L1::no_allocate, L2 evict_first", "probe_kernels",
     {"{ return __ldcs(p); }": """{
  float4 v;
  unsigned long long policy;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  asm volatile("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p), "l"(policy));
  return v;
}"""}),
)
# The kernel whose SASS is counted, by a piece of its mangled name: the
# path's instance (C = 8, vector stores) and the previous designs.
SASS_OF = {"flow_select_rows": "flow_select_rows_kernelILi8ELb1E", "scale2": "scale2_kernel",
           "flow_select_rows previous": "flow_select_rows_prev_kernel",
           "scale2 previous": "scale2_prev_kernel"}


def sass_counts(so: Path, nvcc: str, kernel: str) -> dict:
    """Instructions of the named kernel's SASS (NOPs left out), its LDGs
    before the first STG, its LDGs and STGs."""
    sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        if SASS_OF[kernel] not in func.split("\n", 1)[0]:
            continue
        ops = [o for o in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", func)
               if o != "NOP"]
        stores = [i for i, o in enumerate(ops) if o.startswith("STG")]
        first = stores[0] if stores else len(ops)
        return dict(function=func.split("\n", 1)[0].strip(), instructions=len(ops),
                    ldg_before_first_stg=sum(o.startswith("LDG") for o in ops[:first]),
                    ldg=sum(o.startswith("LDG") for o in ops), stg=len(stores))
    return {}


def build(native):
    """The alternatives' library and one library a source variant; a
    variant that does not compile is reported (``None``)."""
    out_dir = native.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = [(HERE / "select_rows_alternatives.cu", out_dir / "libselect_rows_alternatives.so")]
    for i, (_, _, source, edits) in enumerate(VARIANTS):
        text = (native.CSRC / f"{source}.cu").read_text()
        for old, new in edits.items():
            if old not in text:
                raise RuntimeError(f"variant {i}: {old!r} is not in {source}.cu")
            text = text.replace(old, new)
        cu = out_dir / f"{source}_select_v{i}.cu"
        cu.write_text(text)
        jobs.append((cu, out_dir / f"lib{source}_select_v{i}.so"))
    procs = [(so, subprocess.Popen([native._nvcc(), *native.NVCC_FLAGS, "-o", str(so), str(cu)],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
             for cu, so in jobs]
    libs = []
    for i, (so, proc) in enumerate(procs):
        log = proc.communicate()[0]
        if proc.returncode != 0:
            if i == 0 or not VARIANTS[i - 1][3]:
                raise RuntimeError(f"nvcc failed for {so}:\n{log}")
            libs.append(None)
            print(json.dumps({"variant": VARIANTS[i - 1][1], "built": False}), flush=True)
            print(log[-2000:], file=sys.stderr)
            continue
        libs.append(ctypes.CDLL(str(so)))
    return libs, [so for _, so in jobs]


def bind(splat, libs):
    """(kernel, name, object with the launcher the wrapper calls) for each
    built design."""
    sig = {"flow_select_rows": ("flow_select_rows_launch",
                                splat._SIGNATURES["flow_select_rows_launch"]),
           "scale2": ("scale2_launch", (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                                        ctypes.c_void_p))}
    named = []
    for (kernel, name, _, _), lib in zip(VARIANTS, libs[1:]):
        if lib is None:
            continue
        fn = getattr(lib, sig[kernel][0])
        fn.argtypes, fn.restype = sig[kernel][1], ctypes.c_int
        named.append((kernel, name, types.SimpleNamespace(**{sig[kernel][0]: fn})))
    for kernel, name, fn_name in DESIGNS:
        fn = getattr(libs[0], fn_name)
        fn.argtypes, fn.restype = sig[kernel][1], ctypes.c_int
        named.append((kernel, name, types.SimpleNamespace(**{sig[kernel][0]: fn})))
    return named


def cold_ms(fn, flush, reps: int = 25) -> float:
    """Median device ms of ``fn`` with the L2 cleared before each run (a
    read of ``flush``, larger than the L2, which leaves no dirty line to
    write back) and the run queued behind a sleep kernel, as
    ``chip_smoke.device_ms`` queues it."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        flush.sum()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("select_rows_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from cilantro_tpu_torch import native
    from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
    from cilantro_tpu_torch.slam import splat
    from cilantro_tpu_torch.slam import splat_fusion as sf
    from cilantro_tpu_torch.slam.driver import synthetic_sequence
    from cilantro_tpu_torch.tools import wide_row_probe as probe

    libs, sos = build(native)
    for i, ((kernel, name, source, _), lib, so) in enumerate(zip(VARIANTS, libs[1:], sos[1:])):
        if lib is None:
            continue
        counts = sass_counts(so, native._nvcc(), kernel)
        if kernel == "flow_select_rows":
            text = (so.parent / f"{source}_select_v{i}.cu").read_text()
            pix = int(re.search(r"constexpr int kSelectPix = (\d+);", text).group(1))
            counts.update(pixels_a_thread=pix, instructions_a_pixel=counts["instructions"] / pix)
        cs.emit(variant=name, kernel=kernel, sass=counts)
    for kernel in ("flow_select_rows", "scale2"):
        cs.emit(variant="previous design", kernel=kernel,
                sass=sass_counts(sos[0], native._nvcc(), f"{kernel} previous"))
    named = bind(splat, libs)

    dev = torch.device("cuda")
    k = CameraIntrinsics.kinect_640()
    depths, _ = synthetic_sequence(cs.FRAMES, cs.H, cs.W, k, seed=0)
    frame = {}
    cfg = sf.SplatConfig(radius=cs.RADIUS, margin=cs.MARGIN)
    with cs.path_recorded(sf, frame):
        _, _, spf, _ = sf.run_splat_sequence(depths, k, cfg=cfg, device="cuda")
    r = cs.RADIUS
    cases = (
        ("random codes", cs.phase2_inputs(dev)["flow_select_rows"]),
        ("splat path frame", frame["flow_select_rows"][0]),
    )
    card = cs.card_line()
    built_splat, built_probe = splat._kernels, probe._kernels
    try:
        for case, (rows, code) in cases:
            want = splat.flow_select_rows_plain(rows, code, r)
            bound_ms = cs.select_rows_bytes(rows, code, r) / cs.HBM_BYTES_PER_S * 1e3
            mine = [d for d in named if d[0] == "flow_select_rows"]
            for _, name, lib in mine + mine[::-1]:
                splat._kernels = lambda lib=lib: lib
                run = lambda: splat.flow_select_rows(rows, code, radius=r)  # noqa: E731
                cs.assert_same_bits(f"{name}, {case}", [run()], [want])
                ms = cs.device_ms(run)
                cs.emit(kernel="flow_select_rows", design=name, case=case, ms=ms, bound_ms=bound_ms,
                        bound_share=bound_ms / ms, card=card)
        # Splat fusion's device ms a frame (chip_smoke.py's profile window)
        # with the previous flow_select_rows and this one, in turns.
        this = built_splat()
        previous = types.SimpleNamespace(
            window_read_codes_launch=this.window_read_codes_launch,
            splat_argmin2_launch=this.splat_argmin2_launch,
            flow_select_rows_launch=next(d[2] for d in named if d[1].startswith("previous")
                                         and d[0] == "flow_select_rows").flow_select_rows_launch)
        for name, design in (("previous", previous), ("as built", this), ("as built", this),
                             ("previous", previous)):
            splat._kernels = lambda design=design: design
            prof = cs.profile_window(sf, depths, k, cfg, dev, spf * 1e3)
            cs.emit(kernel="flow_select_rows", design=name, case="splat fusion's frame",
                    device_ms_a_frame=prof.get("device_kernel_ms"),
                    launches_a_frame=prof.get("kernel_launches"), card=card)
        x = torch.from_numpy(np.random.default_rng(3).standard_normal((cs.POOL_CAPACITY // 8, 128))
                             .astype(np.float32)).to(dev)
        want = probe.scale2_plain(x)
        bound_ms = 2 * x.numel() * 4 / cs.HBM_BYTES_PER_S * 1e3
        mul = lambda: torch.mul(x, 2.0)  # noqa: E731
        flush = torch.zeros(2**27, dtype=torch.float32, device=dev)  # 512 MB, ten L2s
        mine = [d for d in named if d[0] == "scale2"]
        for _, name, lib in mine + mine[::-1]:
            probe._kernels = lambda lib=lib: lib
            run = lambda: probe.scale2(x)  # noqa: E731
            cs.assert_same_bits(f"scale2 {name}", [run()], [want])
            pairs = []
            for i in range(5):  # phase 20's alternating pairs
                first, second = (run, mul) if i % 2 == 0 else (mul, run)
                a, b = cs.device_ms(first), cs.device_ms(second)
                pairs.append((a, b) if i % 2 == 0 else (b, a))
            cs.emit(kernel="scale2", design=name, case="probe view (53,760, 128)",
                    ms=statistics.median(p[0] for p in pairs),
                    torch_mul_ms=statistics.median(p[1] for p in pairs), pairs=pairs,
                    slower_in_pairs=sum(a > b for a, b in pairs),
                    cold_l2_ms=cold_ms(run, flush), torch_mul_cold_l2_ms=cold_ms(mul, flush),
                    bound_ms=bound_ms, card=card)
    finally:
        splat._kernels, probe._kernels = built_splat, built_probe
    return 0


if __name__ == "__main__":
    sys.exit(main())
