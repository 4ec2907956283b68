"""Run ``chip_smoke.py``'s nn1 and ICP phases (5-8) and the kNN-normals
registration (phase 15) of one checkout, and a profiler window of one
``entry()`` forward, on one CUDA card:

    python3 cilantro_tpu_torch/tools/icp_phases.py [ROOT]

``ROOT`` (default: the current directory) is the root of a checkout; its
own ``chip_smoke.py`` and ``cilantro_tpu_torch`` are imported, so two
checkouts (say a parent and a change, unpacked with ``git archive``) can be
compared in one call on one card by running this script once for each,
in turns. Prints each phase's JSON lines as ``chip_smoke.py`` does, then one
summary line with the root, the kernels' times and the ICP times.
"""

from __future__ import annotations

import inspect
import os
import sys
import time


def main(root: str) -> int:
    import torch

    if not torch.cuda.is_available():
        print("icp_phases: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    import cilantro_tpu_torch.entry as entry_mod
    from cilantro_tpu_torch import native
    from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
    from cilantro_tpu_torch.entry import _toy_pair
    from cilantro_tpu_torch.neighbors import fused_knn, fused_nn
    from cilantro_tpu_torch.registration import icp as icp_mod
    from cilantro_tpu_torch.slam.driver import synthetic_sequence

    t0 = time.perf_counter()
    native.build(("nn1_kernels", "knn_kernels"))
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    card = cs.card_line()
    k = CameraIntrinsics.kinect_640()
    depths, gt = synthetic_sequence(cs.FRAMES, cs.H, cs.W, k, seed=0)
    pair = (cs.frame_clouds(depths[1], k, dev), cs.frame_clouds(depths[0], k, dev))
    rel = cs.np.linalg.inv(gt[0]) @ gt[1]
    coarse = cs.coarse_clouds(*pair, cs.BENCH_LEVELS[0])
    toy = [torch.as_tensor(a, device=dev) for a in _toy_pair()]

    lines = []
    emit = cs.emit

    def keep(**record):
        lines.append(record)
        emit(**record)

    cs.emit = keep
    try:
        # The masked kernel at the wide-gate path's own first pass, as the
        # checkout's ``icp`` would launch it (with D + 2 terms where the
        # checkout's kernels take them).
        qp, kp, within, _, tq, tm = cs.first_pass(fused_nn, *pair, 0.25)
        mask = within.to(torch.int32)
        live = {"terms": 5} if "terms" in inspect.signature(fused_nn.masked_rows).parameters else {}
        keep(phase="masked_at_wide_gate", survivors=int(within.sum()), ms=cs.device_ms(
            lambda: fused_nn.masked_rows(qp, kp, mask, tile_q=tq, tile_m=tm, **live)), **live)
        nn1 = cs.nn1_kernel_checks(fused_nn, pair, coarse, toy)
        cs.icp_main_path(fused_nn, icp_mod, pair, rel, card)
        cs.wide_gate_path(fused_nn, icp_mod, pair, rel)
        cs.entry_path(fused_nn)
        fwd, args = entry_mod.entry()
        fwd(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd(*args)
        torch.cuda.synchronize()
        keep(phase="entry_profile", **cs.profile_once(lambda: fwd(*args), (time.perf_counter() - t0) * 1e3))
        cloud0 = cs.frame_cloud(depths[0], k, dev)
        cs.knn_normals_registration(fused_knn, fused_nn, icp_mod, pair[0], cloud0, rel)
    finally:
        cs.emit = emit
    by_phase = {}
    for rec in lines:
        by_phase.setdefault(rec["phase"], rec)
    icp, prof = by_phase["icp_main_path"], by_phase.get("icp_profile", {})
    emit(
        summary=root, card=card, build_s=build_s,
        kernel_ms={name: entry["ms"] for name, entry in nn1.items()},
        kernel_cases=[dict(name=r["name"], case=r.get("case", r.get("shape")), ms=r["ms"])
                      for r in lines if r["phase"] == "nn1_kernel_vs_plain"],
        icp_ms=icp["ms"], icp_ms_repeat=icp["ms_repeat"],
        icp_device_ms=prof.get("device_kernel_ms"), icp_idle=prof.get("device_idle_share"),
        icp_launches=prof.get("kernel_launches"), icp_top_kernels=prof.get("top_kernels", [])[:4],
        wide_gate_ms=by_phase["icp_wide_gate_path"]["ms"],
        masked_at_wide_gate_ms=by_phase["masked_at_wide_gate"]["ms"],
        entry_ms=by_phase["entry"]["ms"],
        entry_device_ms=by_phase["entry_profile"].get("device_kernel_ms"),
        entry_idle=by_phase["entry_profile"].get("device_idle_share"),
        entry_top_kernels=by_phase["entry_profile"].get("top_kernels", [])[:3],
        knn_registration_ms=by_phase["knn_normals_registration"]["ms"],
        knn_registration_ms_repeat=by_phase["knn_normals_registration"]["ms_repeat"],
        translation_error_m=icp["translation_error_m"], rotation_error_rad=icp["rotation_error_rad"],
    )
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "."))
