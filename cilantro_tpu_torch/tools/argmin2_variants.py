"""Time ``splat_argmin2``'s kernel beside other designs and source variants
on one CUDA card:

    python3 cilantro_tpu_torch/tools/argmin2_variants.py

Run from the root of a checkout. Builds ``tools/argmin2_alternatives.cu``
(the previous design, one thread scanning a target's candidate sources,
and a gather from a shared-memory halo) and ``csrc/splat_kernels.cu`` with
one constant or expression changed per variant (the tile, the threads a
block, the packing of the visit index) into ``_build/variants/``, then
holds each against the plain version bit for bit and times it
(``chip_smoke.py``'s ``device_ms``) on ``chip_smoke.py``'s tie-heavy case
and on the last frame of a 6-frame run of splat fusion, visiting them
forward and then backward so that drift shows. One JSON line a design and
case, after one line a source variant with the election kernel's SASS:
its instruction count and the opcodes of its shared-memory atomics.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import types
from pathlib import Path

# Other designs: (name, function in the alternatives' library).
DESIGNS = (
    ("previous: scan a target's sources", "argmin2_scan_launch"),
    ("gather from a shared-memory halo", "argmin2_gather_launch"),
)
# Variants of the election: (name, {text in csrc/splat_kernels.cu:
# replacement}); the first is the source as it is.
VARIANTS = (
    ("as built: election in shared memory, tile 64 x 16, 512 threads", {}),
    ("tile 32 x 16", {"constexpr int kTileW = 64;": "constexpr int kTileW = 32;"}),
    ("tile 64 x 8", {"constexpr int kTileH = 16;": "constexpr int kTileH = 8;"}),
    ("tile 64 x 32", {"constexpr int kTileH = 16;": "constexpr int kTileH = 32;"}),
    ("256 threads", {"constexpr int kElectThreads = 512;": "constexpr int kElectThreads = 256;"}),
    ("1024 threads", {"constexpr int kElectThreads = 512;": "constexpr int kElectThreads = 1024;"}),
    ("visit index l * (2R+1)^2 + oc", {
        "static_cast<uint32_t>((l << 16) | oc);": "static_cast<uint32_t>(l * n_oc + oc);",
        "const int l = v >> 16, oc = v & 0xffff;": "const int l = v / n_oc, oc = v - l * n_oc;",
    }),
)


def election_sass(so: Path, nvcc: str) -> dict:
    """The election kernel's SASS instruction count and its shared-memory
    atomic opcodes (a compare-and-swap loop shows as ATOMS.CAST.SPIN)."""
    sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        if "splat_argmin2_kernel" not in func.split("\n", 1)[0]:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", func)
        atoms = sorted({o for o in ops if o.startswith("ATOMS")})
        return dict(instructions=len(ops), shared_atomics=atoms,
                    shared_atomic_count=sum(o.startswith("ATOMS") for o in ops))
    return {}


def build(native, splat):
    """The alternatives' library and one library a source variant."""
    out_dir = native.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = [(Path(__file__).resolve().parent / "argmin2_alternatives.cu",
             out_dir / "libargmin2_alternatives.so")]
    src = (native.CSRC / "splat_kernels.cu").read_text()
    for i, (_, edits) in enumerate(VARIANTS):
        text = src
        for old, new in edits.items():
            if old not in text:
                raise RuntimeError(f"variant {i}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu = out_dir / f"splat_v{i}.cu"
        cu.write_text(text)
        jobs.append((cu, out_dir / f"libsplat_v{i}.so"))
    procs = [(so, subprocess.Popen([native._nvcc(), *native.NVCC_FLAGS, "-o", str(so), str(cu)],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
             for cu, so in jobs]
    libs = []
    for so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {so}:\n{log}")
        libs.append(ctypes.CDLL(str(so)))
    argtypes = splat._SIGNATURES["splat_argmin2_launch"]
    alt, variants = libs[0], libs[1:]
    for _, fn in DESIGNS:
        getattr(alt, fn).argtypes = argtypes
        getattr(alt, fn).restype = ctypes.c_int
    for lib in variants:
        lib.splat_argmin2_launch.argtypes = argtypes
        lib.splat_argmin2_launch.restype = ctypes.c_int
    named = [(name, lib) for (name, _), lib in zip(VARIANTS, variants)]
    named += [(name, types.SimpleNamespace(splat_argmin2_launch=getattr(alt, fn))) for name, fn in DESIGNS]
    return named, [election_sass(so, native._nvcc()) for _, so in jobs[1:]]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("argmin2_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from cilantro_tpu_torch import native
    from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
    from cilantro_tpu_torch.slam import splat
    from cilantro_tpu_torch.slam import splat_fusion as sf
    from cilantro_tpu_torch.slam.driver import synthetic_sequence

    named, sass = build(native, splat)
    for (name, _), counts in zip(VARIANTS, sass):
        cs.emit(variant=name, sass=counts)
    built = splat._kernels
    dev = torch.device("cuda")
    k = CameraIntrinsics.kinect_640()
    depths, _ = synthetic_sequence(6, cs.H, cs.W, k, seed=0)
    frame = {}
    with cs.path_recorded(sf, frame):
        sf.run_splat_sequence(depths, k, cfg=sf.SplatConfig(radius=cs.RADIUS, margin=cs.MARGIN),
                              device="cuda")
    cases = (
        ("tie-heavy random", cs.argmin2_tie_case(np.random.default_rng(0), dev)),
        ("splat path frame", frame["splat_argmin2"][0]),
    )
    card = cs.card_line()
    try:
        for case, (key, off) in cases:
            want = splat.splat_argmin2_plain(key, off, cs.RADIUS)
            bound_ms = cs.argmin2_bytes(off) / cs.HBM_BYTES_PER_S * 1e3
            for name, lib in named + named[::-1]:
                splat._kernels = lambda lib=lib: lib
                run = lambda: splat.splat_argmin2(key, off, radius=cs.RADIUS)  # noqa: E731
                cs.assert_same_bits(f"{name}, {case}", run(), want)
                ms = cs.device_ms(run)
                cs.emit(design=name, case=case, ms=ms, bound_ms=bound_ms, bound_share=bound_ms / ms,
                        launch=dict(splat.kernel_design["splat_argmin2"]), card=card)
    finally:
        splat._kernels = built
    return 0


if __name__ == "__main__":
    sys.exit(main())
