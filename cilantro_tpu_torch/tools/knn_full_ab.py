"""Time the full kNN kernel's two designs, and variants of the warp design's
plan, against each other on one CUDA card:

    python3 cilantro_tpu_torch/tools/knn_full_ab.py

Run from the root of a checkout. ``knn_full_rows`` picks its design from
the shapes (``fused_knn._full_plan``); this tool reaches both designs
through the internal launcher ``fused_knn._full_launch`` with a forced
plan: a thread per query (the earlier design) and a warp per query, each with
the grid the route would give it, and variants of the warp design's plan
(4 or 8 warps a block, no key splits, key splits toward 8 blocks an SM).
Each design is held bit for bit against ``knn_full_rows_plain`` on each
case and timed with ``chip_smoke.py``'s ``device_ms``, visiting the
designs forward and then backward: one JSON line a (case, design) with
both visits, beside ``torch.cdist`` + ``torch.topk`` over the same points
(a two-call yardstick), the arithmetic bound and an empty launch.

Alone, the tool times the route's deciding cases on stand-ins made from a
seed (mean shift's converged modes as 4 tight clusters of 300, the
120,000-point height field of ``chip_smoke.warp_inputs``, the rings of the
``spectral_and_components`` example, random clouds, the planted blobs).
``chip_smoke.py`` phase 40 calls :func:`ab` with the two designs on the
inputs its paths recorded.
"""

from __future__ import annotations

import os
import statistics
import sys

THREAD = "a thread per query (the earlier design)"
WARP = "a warp per query (as built)"
# Runtime variants of the warp design's plan: (name, warps a block, no key
# splits, or the blocks an SM the splits aim for; unset keeps the route's).
PLAN_VARIANTS = (
    ("warp: 4 warps a block", {"warps": 4}),
    ("warp: 8 warps a block", {"warps": 8}),
    ("warp: no key splits", {"splits": 1}),
    ("warp: key splits toward 8 blocks an SM", {"blocks_per_sm": 8}),
)


def designs(plan_variants=()) -> list:
    """``[(name, plan(n_queries, n_keys, k, sms))]``: the two designs, then
    the plan variants."""
    from cilantro_tpu_torch.neighbors import fused_knn as fk

    def forced(design):
        return lambda nq, nk, k, sms: fk._full_plan(nq, nk, k, sms, design=design)

    def varied(warps=None, splits=None, blocks_per_sm=fk._WARP_BLOCKS_PER_SM):
        def plan(nq, nk, k, sms):
            routed = fk._full_plan(nq, nk, k, sms, design="warp")
            w = warps or routed["queries_per_block"]
            if splits == 1:
                s, length = 1, fk._WARP_STAGE * -(-nk // fk._WARP_STAGE)
            else:
                s, length = fk._key_splits(nk, -(-nq // w), fk._WARP_STAGE, 16 * k, blocks_per_sm * sms)
            return dict(routed, queries_per_block=w, splits=s, keys_per_split=length, blocks=-(-nq // w) * s)
        return plan

    return [(THREAD, forced("thread")), (WARP, forced("warp"))] + [
        (name, varied(**fields)) for name, fields in plan_variants]


def full_case(q, keys, k, diag, key_valid=None):
    """``knn_fused``'s operands of these points: the augmented real rows."""
    from cilantro_tpu_torch.neighbors import fused_knn as fk

    qp, kp = fk._augment(q, keys, key_valid, 512, 2048)
    return qp[: q.shape[0]].contiguous(), kp[: keys.shape[0]].contiguous(), min(k, keys.shape[0]), diag


def synthetic_cases(cs) -> dict:
    """The deciding cases on stand-ins made from seeds (see the module
    docstring): ``{label: (qp, kp, k, exclude_diag)}``."""
    import numpy as np
    import torch

    dev = torch.device("cuda")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    rng = np.random.default_rng(0)
    centers = np.array([[0, 0, 0], [3, 0, 0], [0, 3, 0], [0, 0, 3]], np.float32)
    modes = t(np.repeat(centers, 300, axis=0) + rng.normal(0, 1e-4, (1200, 3)))
    field = t(cs.warp_inputs()[0])
    th = [rng.uniform(0, 2 * np.pi, 200) for _ in range(3)]
    rings = t(np.concatenate([np.column_stack([r * np.cos(a), r * np.sin(a)]) for r, a in zip((1, 3, 5), th)])
              + rng.normal(0, 0.05, (600, 2)))
    rand = t(np.random.default_rng(2).uniform(-1, 1, (4096, 3)))
    small = t(rng.uniform(-1, 1, (16, 3)))
    frame = t(rng.uniform(-1, 1, (512, 3)))
    cases = {
        "a: mean shift merge (modes of 4 x 300)": full_case(modes, modes, 33, False),
        "b: mean shift, capped path": full_case(modes, modes, 513, False),
        "c: kd_tree radius search (2,000 x 120,000)": full_case(field[:2000], field, 33, True),
        "d: spectral_and_components rings": full_case(rings, rings, 12, True),
        "e: dryrun ICP pair (16 x 16)": full_case(small, small, 4, False),
    }
    cases.update({f"f: random 4096, k = {k}": full_case(rand, rand, k, False) for k in (33, 65, 200)})
    cases["g: 7,968 points of the height field (phase 16's size)"] = full_case(field[:7968], field[:7968], 12, False)
    cases.update({f"g: random 4096, k = {k}": full_case(rand, rand, k, False) for k in (1, 12)})
    blobs = t(cs.blobs(10_000))
    cases["h: spectral graph (30,000 blob points)"] = full_case(blobs, blobs, 12, True)
    cases["h: kd_tree kNN (2,000 x 120,000)"] = full_case(field[:2000], field, 5, True)
    cases["h: robust_normals (4,000 points)"] = full_case(field[:4000], field[:4000], 24, True)
    cases["h: batched_serving (512 x 341)"] = full_case(frame, frame[:341], 8, False)
    return cases


def real_points(qp, kp):
    """The query and key points behind augmented rows (D from the layout:
    the key rows' last nonzero column is ‖k‖², after the 1), and the live
    keys (a finite norm)."""
    import torch

    dim = int(torch.nonzero(kp.abs().sum(0)).max()) - 1
    q = -0.5 * qp[:, :dim]
    live = kp[:, dim + 1] < 1e37
    return q, kp[live, :dim], dim


def ab(named, cases: dict, card: str, strict: bool = True) -> dict:
    """Each design on each case: held bit for bit against the plain version,
    then timed visiting the designs forward and backward. Returns ``{case:
    {design: ms}}`` (the mean of the two visits) and prints one line a
    (case, design). ``strict=False`` reports a design that differs from the
    plain version and leaves it out of that case instead of raising."""
    import torch

    import chip_smoke as cs
    from cilantro_tpu_torch.neighbors import fused_knn as fk

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    empty_ms = cs.device_ms(lambda: torch.cuda._sleep(0))
    result = {}
    for label, (qp, kp, k, diag) in cases.items():
        want = fk.knn_full_rows_plain(qp, kp, k, diag)
        q, keys, dim = real_points(qp, kp)
        library_ms = cs.device_ms(lambda: torch.topk(torch.cdist(q, keys), min(k, keys.shape[0]),  # noqa: B023
                                                     dim=1, largest=False))
        pairs = qp.shape[0] * keys.shape[0]
        nbytes = (qp.numel() + kp.numel()) * 4 + qp.shape[0] * k * 8
        bound_ms, bound_by = cs.nn1_bound(pairs, nbytes, dim)
        visits, plans, wrong = {}, {}, set()
        for name, plan_of in named + named[::-1]:
            plan = plans.setdefault(name, plan_of(qp.shape[0], kp.shape[0], k, sms))
            run = lambda: fk._full_launch(qp, kp, k, diag, plan)  # noqa: E731, B023
            if name not in visits and name not in wrong:
                got = run()
                torch.cuda.synchronize()
                try:
                    cs.assert_same_bits(f"knn_full design {name!r} on {label}", got, want)
                except AssertionError as e:
                    if strict:
                        raise
                    wrong.add(name)
                    bad_rows = (got[1] != want[1]).any(dim=1).nonzero()[:4, 0].tolist()
                    cs.emit(phase="knn_full_designs_ab", case=label, design=name, error=str(e), plan=plan,
                            rows=[dict(row=r, got=got[1][r, :8].tolist(), want=want[1][r, :8].tolist(),
                                       got_d=got[0][r, :8].tolist(), want_d=want[0][r, :8].tolist())
                                  for r in bad_rows])
            if name not in wrong:
                visits.setdefault(name, []).append(cs.device_ms(run))
        result[label] = {}
        for name, _ in named:
            if name in wrong or THREAD not in visits:
                continue
            ms = statistics.fmean(visits[name])
            result[label][name] = ms
            cs.emit(phase="knn_full_designs_ab", tolerance="bit-exact", case=label, design=name,
                    query_rows=int(qp.shape[0]), key_rows=int(kp.shape[0]), live_keys=int(keys.shape[0]), k=k,
                    exclude_diag=diag, plan=plans[name], visits_ms=visits[name], ms=ms,
                    vs_thread=ms / statistics.fmean(visits[THREAD]), library_ms=library_ms,
                    vs_library=ms / library_ms, bound_ms=bound_ms, bound_by=bound_by, empty_launch_ms=empty_ms,
                    routed=fk._full_plan(qp.shape[0], kp.shape[0], k, sms)["design"],
                    library_is="torch.cdist + topk over the same points (two calls, a yardstick)", card=card)
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("knn_full_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    card = cs.card_line()
    ab(designs(PLAN_VARIANTS), synthetic_cases(cs), card, strict=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
