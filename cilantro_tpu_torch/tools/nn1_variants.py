"""Time variants of the three nn1 kernels on one CUDA card:

    python3 cilantro_tpu_torch/tools/nn1_variants.py

Run from the root of a checkout. Builds ``csrc/nn1_kernels.cu`` as it is
and with one constant changed per variant (the rows a thread, the
distances in flight a thread, the fused kernel's key splits: the waves of
resident blocks it aims at and the least keys a split) into
``_build/variants/``, then holds each against the plain version bit for
bit and times it (``chip_smoke.py``'s ``device_ms``): the fused kernel at
the ``entry()`` pair (4096²) and at the coarse ICP level (32768²), the
masked and compact ones at the first full-resolution pass of
``icp_multires`` on the 640×480 pair and at the first pass of the 0.5 m
gate, visiting the variants forward and then backward so that drift
shows. One JSON line a variant and case, after one line per variant with
the instructions a (query, key) pair in each kernel instance's distance
loop, counted in the SASS that ``cuobjdump`` prints.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

# (name, {text in the source: replacement}); the first is the source as it is.
VARIANTS = (
    ("as built: 4 rows, 16 in flight", {}),
    ("2 rows a thread", {"for (int r = 4; r > 1; r /= 2)": "for (int r = 2; r > 1; r /= 2)"}),
    ("1 row a thread", {"for (int r = 4; r > 1; r /= 2)": "for (int r = 1; r > 1; r /= 2)"}),
    ("8 in flight", {"constexpr int kChains = 16;": "constexpr int kChains = 8;"}),
    ("fused: 1 wave", {"constexpr int kFusedWaves = 4;": "constexpr int kFusedWaves = 1;"}),
    ("fused: 16 waves", {"constexpr int kFusedWaves = 4;": "constexpr int kFusedWaves = 16;"}),
    ("fused: splits of 64 keys or more",
     {"constexpr int kFusedMinKeys = kThreads;": "constexpr int kFusedMinKeys = 64;"}),
)


def loop_counts(so: Path, nvcc: str, chains: int):
    """Per fused / masked / compact instance: the instructions of its distance loop
    (the smallest loop whose FMULs are chains x NT, one per term of
    ``chains`` pairs) over its pairs, with the loop's opcode counts."""
    sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"(fused|masked|compact)_kernelILi(\d)ELi(\d)E", func.split("\n", 1)[0])
        if not m:
            continue
        nt = int(m.group(2))
        ins = [(int(a, 16), op) for a, op in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)]
        where = {a: i for i, (a, _) in enumerate(ins)}
        best = None
        for i, (a, op) in enumerate(ins):
            jump = re.search(r"BRA\s.*?0x([0-9a-f]+)", op)
            if jump and int(jump.group(1), 16) < a and int(jump.group(1), 16) in where:
                body = [o for _, o in ins[where[int(jump.group(1), 16)]: i + 1]]
                if sum(bool(re.search(r"\bFMUL\b", o)) for o in body) == chains * nt:
                    if best is None or len(body) < len(best):
                        best = body
        if best:
            ops = {}
            for o in best:
                name = re.sub(r"^@!?U?P\w+\s+", "", o).split()[0]
                ops[name] = ops.get(name, 0) + 1
            out[f"{m.group(1)}<{nt},{m.group(3)}>"] = dict(
                instructions_per_pair=len(best) / chains, ops=ops)
    return out


def build(native):
    src = (native.CSRC / "nn1_kernels.cu").read_text()
    out_dir = native.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (_, edits) in enumerate(VARIANTS):
        text = src
        for old, new in edits.items():
            if old not in text:
                raise RuntimeError(f"variant {i}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu, so = out_dir / f"nn1_v{i}.cu", out_dir / f"libnn1_v{i}.so"
        cu.write_text(text)
        cmd = [native._nvcc(), *native.NVCC_FLAGS, "-o", str(so), str(cu)]
        procs.append((so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs, sass = [], []
    for so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {so}:\n{log}")
        libs.append(native.declare(ctypes.CDLL(str(so)), "nn1_kernels"))
        chains = int(re.search(r"kChains = (\d+);", (so.parent / so.name[3:].replace(".so", ".cu")).read_text()).group(1))
        sass.append(loop_counts(so, native._nvcc(), chains))
    return libs, sass


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("nn1_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from cilantro_tpu_torch import native
    from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
    from cilantro_tpu_torch.entry import _toy_pair
    from cilantro_tpu_torch.neighbors import fused_nn as nn
    from cilantro_tpu_torch.slam.driver import synthetic_sequence

    libs, sass = build(native)
    built = native.load
    for (name, _), counts in zip(VARIANTS, sass):
        cs.emit(variant=name, sass_distance_loop=counts)
    dev = torch.device("cuda")
    k = CameraIntrinsics.kinect_640()
    depths, _ = synthetic_sequence(cs.FRAMES, cs.H, cs.W, k, seed=0)
    pair = (cs.frame_clouds(depths[1], k, dev), cs.frame_clouds(depths[0], k, dev))
    order = list(range(len(VARIANTS)))
    coarse = cs.coarse_clouds(*pair, cs.BENCH_LEVELS[0])
    toy = [torch.as_tensor(a, device=dev) for a in _toy_pair()]
    for case, (q, kk, kv) in (("4096x4096", (toy[0], toy[1], None)),
                              ("32768x32768", (coarse[0][0], coarse[1][0], coarse[1][2]))):
        qp, kp = nn._augment(q, kk, kv, nn._fused_rows_multiple(q.shape[0]), 1)
        want = nn.fused_rows_plain(qp, kp)
        for i in order + order[::-1]:
            native.load = lambda name, lib=libs[i]: lib if name == "nn1_kernels" else built(name)
            fused = lambda: nn.fused_rows(qp, kp, terms=5)
            cs.assert_same_bits(f"{VARIANTS[i][0]} fused", fused(), want)
            cs.emit(variant=VARIANTS[i][0], case=case, fused_ms=cs.device_ms(fused),
                    fused_design=nn.kernel_design["nn1_fused"], card=cs.card_line())
    for case, mcd in (("first pass", cs.BENCH_LEVELS[1][3]), ("wide-gate first pass", 0.25)):
        qp, kp, within, budget, tq, tm = cs.first_pass(nn, *pair, mcd)
        mask = within.to(torch.int32)
        want = nn.masked_rows_plain(qp, kp, mask, tq, tm)
        lst = nn._compact_list(within, within.numel())
        for i in order + order[::-1]:
            native.load = lambda name, lib=libs[i]: lib if name == "nn1_kernels" else built(name)
            masked = lambda: nn.masked_rows(qp, kp, mask, tile_q=tq, tile_m=tm, terms=5)
            compact = lambda: nn.compact_rows(qp, kp, *lst, tile_q=tq, tile_m=tm, terms=5)
            cs.assert_same_bits(f"{VARIANTS[i][0]} masked", masked(), want)
            cs.assert_same_bits(f"{VARIANTS[i][0]} compact", compact(), want)
            cs.emit(variant=VARIANTS[i][0], case=case, survivors=int(within.sum()),
                    compact_ms=cs.device_ms(compact), masked_ms=cs.device_ms(masked),
                    compact_design=nn.kernel_design["nn1_compact"],
                    masked_design=nn.kernel_design["nn1_masked"], card=cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
