"""Time ``coalesced_gather``'s kernel beside its first design, other designs
and source variants on one CUDA card:

    python3 cilantro_tpu_torch/tools/gather_variants.py

Run from the root of a checkout. Builds ``tools/gather_alternatives.cu``
(the first design, the width at compile time alone, two sub-tiles a warp
tile, bulk copies of runs) and ``csrc/gather_kernels.cu`` once a variant,
each with its ``GATHER_*`` macros set by ``-D`` (the grid's rounds, store
and load cache hints, threads a block), into ``_build/variants/`` under a
hash of the source, the flags and the macros, so an unchanged variant is
not compiled again; a variant the compiler refuses is reported and left
out. Each design is then called through its launcher on the recorded index
streams, held against ``coalesced_gather_plain`` bit for bit and timed
(``chip_smoke.py``'s ``device_ms``), visiting the designs forward and then
backward so that drift shows: one JSON line a (design, stream) with both
visits, both byte bounds (distinct 32- or 64-byte rows, and distinct
64-byte segments of the source) and the share of each, beside
``torch.index_select``.

Alone, the tool records the streams of ``chip_smoke.py``'s phase 10 (the
pool path's integrate, update and ICP gathers), phase 11's random and
30%-wildcard cases, the first 76,800 and 19,200 rows of the integrate and
ICP streams (the sizes of the SLAM rebuild's and the projective warp's
gathers) and phase 28's B = 8 gather sites, and adds rows at a
stride of 1, 2 and 4 of the B = 8 ICP source (timed also with the L2
cleared before each run), which tell whether the memory system moves whole
64-byte segments. ``chip_smoke.py`` builds the variants with its kernels
in phase 1 and calls :func:`ab` with every stream its paths recorded
(phases 11, 25, 26, 28, 34 and 35).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent

FIRST = "the first design: one float4 a thread, 64-bit division, default stores"
BUILT = "as built"
# Other designs: (name, function in the alternatives' library).
DESIGNS = (
    (FIRST, "coalesced_gather_first_launch"),
    ("width at compile time alone: one index load and one float4 a thread", "coalesced_gather_width_launch"),
    ("2 sub-tiles a warp tile (2 Q loads a lane in flight), every row through L1, resident grid",
     "coalesced_gather_tiles_launch"),
    ("bulk copies (TMA) of 32-row runs through shared memory", "coalesced_gather_bulk_launch"),
)
# Source variants of csrc/gather_kernels.cu: (name, macros passed with -D);
# the first is the source as built.
VARIANTS = (
    (BUILT, ()),
    ("no resident grid: one warp a tile at every size", ("GATHER_MAX_ROUNDS=0",)),
    ("resident grid at every size", ("GATHER_MAX_ROUNDS=1048576",)),
    ("default stores", ("GATHER_STREAMING_STORES=0",)),
    ("every row through L1", ("GATHER_UNCACHED_MAX_WIDTH=0",)),
    ("rows of either width outside a run skip L1", ("GATHER_UNCACHED_MAX_WIDTH=16",)),
    ("8-wide rows skip L1, runs too", ("GATHER_RUNS_THROUGH_L1=0",)),
    ("128 threads a block", ("GATHER_THREADS=128",)),
)
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p)


def _library(native, cu: Path, defines) -> tuple:
    """``(flags, library)``: the ``nvcc`` flags with the macros, and the
    library's path under a hash of the source and those flags."""
    flags = [*native.NVCC_FLAGS, *(f"-D{d}" for d in defines)]
    digest = hashlib.sha256(cu.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return flags, native.BUILD_DIR / "variants" / f"lib{cu.stem}-{digest}.so"


def start_build(native):
    """Start one ``nvcc`` for each library not built yet (the alternatives
    and each source variant), all at once, into ``_build/variants/``;
    returns the jobs for :func:`finish_build`."""
    (native.BUILD_DIR / "variants").mkdir(parents=True, exist_ok=True)
    jobs = [(FIRST, HERE / "gather_alternatives.cu", ())]
    jobs += [(name, native.CSRC / "gather_kernels.cu", defines) for name, defines in VARIANTS]
    started = []
    for name, cu, defines in jobs:
        flags, so = _library(native, cu, defines)
        tmp, proc = so.with_name(f"{so.name}.{os.getpid()}.tmp"), None
        if not so.exists():
            proc = subprocess.Popen([native._nvcc(), *flags, "-o", str(tmp), str(cu)], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        started.append((name, so, tmp, proc))
    return started


def finish_build(jobs):
    """``[(design, launcher)]``: the first design, the source as built,
    then the other variants and designs. A variant that does not
    compile is reported and left out; the alternatives or the source as
    built failing raises."""
    libs = {}
    for name, so, tmp, proc in jobs:
        ptxas = "built before"
        if proc is not None:
            log = proc.communicate()[0]
            if proc.returncode != 0:
                if name in (FIRST, BUILT):
                    raise RuntimeError(f"nvcc failed for {so}:\n{log}")
                print(json.dumps({"gather_variant": name, "built": False}), flush=True)
                print(log[-2000:], file=sys.stderr)
                continue
            os.replace(tmp, so)
            ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(json.dumps({"gather_variant": name, "built": True, "ptxas": ptxas}), flush=True)
        libs[name] = ctypes.CDLL(str(so))

    def bound(lib, fn_name):
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        return fn

    alt = libs[FIRST]
    named = [(FIRST, bound(alt, DESIGNS[0][1]))]
    named += [(name, bound(libs[name], "coalesced_gather_launch")) for name, _ in VARIANTS if name in libs]
    named += [(name, bound(alt, fn_name)) for name, fn_name in DESIGNS[1:]]
    return named


def stride_cases(src, n: int) -> dict:
    """``n`` rows of ``src`` at a stride of 1, 2 and 4 rows."""
    import torch

    base = torch.arange(n, dtype=torch.int32, device=src.device)
    return {f"rows at stride {s} of the B = 8 ICP source": (src, base * s) for s in (1, 2, 4)
            if (n - 1) * s < src.shape[0]}


def ab(named, streams: dict, card: str, cold=()) -> dict:
    """Each design on each stream: held bit for bit against the plain gather,
    then timed with ``device_ms`` visiting the designs forward and backward
    (the first design at both ends). Streams named in ``cold`` are also timed
    with the L2 cleared before each run. Returns ``{stream: {design: ms}}``
    (the mean of the two visits) and prints one line a (design, stream)."""
    import torch

    import chip_smoke as cs
    from cilantro_tpu_torch.core import coalesced as cg
    from cilantro_tpu_torch.tools.select_rows_variants import cold_ms

    flush = torch.empty(2**27, dtype=torch.float32, device="cuda") if cold else None  # 512 MB
    result = {}
    for label, (src, idx) in streams.items():
        c, w = src.shape
        n = idx.shape[0]
        out = torch.empty((n, w), dtype=torch.float32, device=src.device)
        stream = torch.cuda.current_stream().cuda_stream
        want = cg.coalesced_gather_plain(src, idx)
        sizes = cs.gather_bytes(src, idx)
        bound_ms = sizes["bytes"] / cs.HBM_BYTES_PER_S * 1e3
        bound_64b_ms = sizes["bytes_64b"] / cs.HBM_BYTES_PER_S * 1e3
        library_ms = cs.device_ms(lambda: torch.index_select(src, 0, idx.clamp(0, c - 1)))  # noqa: B023
        visits = {}
        for name, fn in named + named[::-1]:
            run = lambda: fn(src.data_ptr(), idx.data_ptr(), out.data_ptr(), c, w, n, stream)  # noqa: E731, B023
            if name not in visits:
                out.fill_(float("nan"))
                err = run()
                torch.cuda.synchronize()
                if err != 0:
                    raise RuntimeError(f"gather design {name!r} on {label}: launch failed with error {err}")
                cs.assert_same_bits(f"gather design {name!r} on {label}", [out], [want])
            visits.setdefault(name, []).append(cs.device_ms(run))
        result[label] = {}
        for name, _ in named:
            ms = statistics.fmean(visits[name])
            result[label][name] = ms
            rec = dict(design=name, stream=label, visits_ms=visits[name], ms=ms,
                       vs_first=ms / statistics.fmean(visits[FIRST]), bound_ms=bound_ms, bound_share=bound_ms / ms,
                       bound_64b_ms=bound_64b_ms, bound_64b_share=bound_64b_ms / ms,
                       index_select_ms=library_ms, card=card, **sizes)
            if label in cold and name in (FIRST, BUILT):
                fn = dict(named)[name]
                rec["cold_l2_ms"] = cold_ms(
                    lambda: fn(src.data_ptr(), idx.data_ptr(), out.data_ptr(), c, w, n, stream), flush)  # noqa: B023
            cs.emit(phase="gather_designs_ab", tolerance="bit-exact", **rec)
    return result


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("gather_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from cilantro_tpu_torch import native
    from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
    from cilantro_tpu_torch.slam.driver import synthetic_sequence

    jobs = start_build(native)
    native.build(("gather_kernels", "rotation_kernels"))
    named = finish_build(jobs)
    card = cs.card_line()
    k = CameraIntrinsics.kinect_640()
    depths, gt = synthetic_sequence(cs.FRAMES, cs.H, cs.W, k, seed=0)
    _, streams, _ = cs.pool_main_path(depths, gt, k, card)
    cases = {f"phase 11, {label}": case for label, case in cs.gather_cases(streams).items()}
    (src16, idx16), (src8, idx8) = streams["integrate_rows"], streams["icp_projective"]
    cases["the integrate stream's first 76,800 rows (a SLAM rebuild's size)"] = (src16, idx16[:76_800])
    cases["the ICP stream's first 19,200 rows (the projective warp's size)"] = (src8, idx8[:19_200])
    seqs = [synthetic_sequence(cs.BATCH_FRAMES, cs.H, cs.W, k, seed=100 + b) for b in range(cs.BATCH_STREAMS)]
    sites = {}
    cs.batched_eager_pass(np.stack([np.stack(d) for d, _ in seqs]), k, sites, {})
    cases.update({f"phase 28, batched {site}, last step": case for site, case in sites.items()})
    icp_src, icp_idx = sites["icp_projective"]
    strided = stride_cases(icp_src, icp_idx.shape[0])
    cases.update(strided)
    ab(named, cases, card, cold=(*strided, "phase 28, batched icp_projective, last step"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
