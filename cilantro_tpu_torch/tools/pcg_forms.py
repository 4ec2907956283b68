"""The BA's other PCG form, kept for measurement: the host reads JAX's
loop condition (``k == done`` and ``r·r > cg_tol``) every ``chunk``
iterations and ends the loop once it fails, where
``slam/bundle_adjustment.py`` runs all ``max_cg`` iterations, masked, with
no read. Both give the same bits: a frozen iteration changes nothing.

``chip_smoke.py`` phase 27 times the two forms at mapping scale with
:func:`reads_every`. Alone, on one CUDA card:

    python -m cilantro_tpu_torch.tools.pcg_forms

prints one JSON line of device ms (CUDA events, best of 3) of a
``bundle_adjust`` at K = 64, L = 100,000, O = 300,000 (3 outer
iterations) in each form, at ``max_cg`` 30 and 60.
"""

from __future__ import annotations

import contextlib
import json
import sys
from unittest import mock

import torch

from ..slam import bundle_adjustment as tba


def pcg_schur_reads(g, h_cc, h_cl, h_ll_inv, cam_idx, lmk_idx, seg, keep, damping, max_cg=60,
                    cg_tol=1e-10, *, chunk=1):
    """:func:`tba._pcg_schur` with a host read of the loop flag every
    ``chunk`` iterations."""
    keep6 = keep[:, None]
    eye6 = torch.eye(6, dtype=g.dtype, device=g.device)
    prec = tba._inv(h_cc + (damping + 1e-8) * eye6)

    def mv(v):
        v = v * keep6
        out = tba._schur_matvec(v, h_cc, h_cl, h_ll_inv, cam_idx, lmk_idx, seg, damping)
        return out * keep6 + v * (1.0 - keep6)

    def apply_prec(r):
        return tba._mv(prec, r) * keep6

    b = g * keep6
    x = torch.zeros_like(b)
    r = b
    z = apply_prec(r)
    p = z
    rz = torch.sum(r * z)
    k = torch.zeros((), dtype=torch.int32, device=g.device)
    done = 0
    while done < max_cg and (done == 0 or bool((k == done) & (torch.sum(r * r) > cg_tol))):
        for _ in range(min(chunk, max_cg - done)):
            active = torch.sum(r * r) > cg_tol
            ap = mv(p)
            alpha = rz / torch.clamp(torch.sum(p * ap), min=tba._EPS)
            x = torch.where(active, x + alpha * p, x)
            r1 = r - alpha * ap
            z1 = apply_prec(r1)
            rz1 = torch.sum(r1 * z1)
            beta = rz1 / torch.clamp(rz, min=tba._EPS)
            p = torch.where(active, z1 + beta * p, p)
            r = torch.where(active, r1, r)
            rz = torch.where(active, rz1, rz)
            k = k + active.to(torch.int32)
            done += 1
    return x, k


@contextlib.contextmanager
def reads_every(chunk: int):
    """A context in which ``bundle_adjust`` runs :func:`pcg_schur_reads`
    with a host read every ``chunk`` iterations."""
    def form(*args, **kwargs):
        return pcg_schur_reads(*args, chunk=chunk, **kwargs)

    with mock.patch.object(tba, "_pcg_schur", form):
        yield


def main() -> int:
    if not torch.cuda.is_available():
        print("pcg_forms: no CUDA device", file=sys.stderr)
        return 2
    from .. import interop
    from .slam_problems import mapping_ba_problem

    dev = torch.device("cuda")
    args = interop.ba_problem_from_numpy(*mapping_ba_problem(64, 100_000, 300_000), device=dev)

    def best_ms(max_cg):
        times = []
        for _ in range(4):  # the first run warms the handles up
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            tba.bundle_adjust(*args, max_iterations=3, max_cg=max_cg, device=dev)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return min(times[1:])

    out = {}
    for max_cg in (30, 60):
        out[f"max_cg={max_cg}, no host read"] = best_ms(max_cg)
        with reads_every(1):
            out[f"max_cg={max_cg}, a host read an iteration"] = best_ms(max_cg)
    print(json.dumps(dict(tool="pcg_forms", device=torch.cuda.get_device_name(0), events_ms=out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
