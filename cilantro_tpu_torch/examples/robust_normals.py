"""Robust (MCD) normal estimation (port of ``examples/robust_normals.py``;
reference ``examples/robust_normal_estimation.cpp``): plain vs
Minimum-Covariance-Determinant neighbourhood fits on an
outlier-contaminated surface, with the chi-square inlier gate.

The JAX script draws the MCD trials from ``jax.random.PRNGKey(s)``; here
they come from a ``torch.Generator`` seeded with ``s``: other draws, the
same planted truth.

Usage: python -m cilantro_tpu_torch.examples.robust_normals [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core.covariance import mcd_mean_cov
from ..core.normals import estimate_normals_knn, estimate_normals_robust
from ._common import generator, parser


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--points", type=int, default=4000, help="points of the contaminated plane")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)

    # Flat plane (true normal +z) with 25% gross outliers above it.
    n = args.points
    pts = np.column_stack(
        [rng.uniform(-1, 1, (n, 2)), rng.normal(0, 0.002, n)]
    ).astype(np.float32)
    n_out = n // 4
    out_idx = rng.choice(n, n_out, replace=False)
    pts[out_idx, 2] += rng.uniform(0.05, 0.3, n_out)

    truth = np.array([0, 0, 1.0], np.float32)
    view = torch.tensor([0, 0, 10.0], device=dev)
    pts_t = torch.as_tensor(pts, device=dev)

    plain_n, _, _ = estimate_normals_knn(pts_t, k=24, view_point=view)
    rob_n, _, rob_ok = estimate_normals_robust(generator(0, dev), pts_t, k=24, view_point=view)

    clean = np.ones(n, bool)
    clean[out_idx] = False

    def ang(nn):
        return np.degrees(np.arccos(np.clip(np.abs(nn.cpu().numpy() @ truth), 0, 1)))

    print(
        f"clean-point normal error: plain {np.median(ang(plain_n)[clean]):.2f}° "
        f"vs robust {np.median(ang(rob_n)[clean]):.2f}° (median)"
    )

    # Chi-square gate: an outlier query against its own neighbourhood flips
    # valid to False (covariance.hpp:352-359).
    nbr = pts[rng.choice(np.flatnonzero(clean), 60)]
    inlier_set = np.vstack([pts[clean][:1], nbr]).astype(np.float32)
    outlier_set = np.vstack([pts[out_idx][:1], nbr]).astype(np.float32)
    _, _, ok_in = mcd_mean_cov(
        generator(1, dev), torch.as_tensor(inlier_set, device=dev), chi_square_threshold=7.81
    )
    _, _, ok_out = mcd_mean_cov(
        generator(1, dev), torch.as_tensor(outlier_set, device=dev), chi_square_threshold=7.81
    )
    print(
        f"chi-square gate: inlier query valid={bool(ok_in)}, "
        f"outlier query valid={bool(ok_out)}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
