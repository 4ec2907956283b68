"""Multidimensional scaling + PCA (port of ``examples/mds_and_pca.py``;
reference ``examples/multidimensional_scaling.cpp`` +
``principal_component_analysis.cpp``).

Usage: python -m cilantro_tpu_torch.examples.mds_and_pca [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core.pca import fit_pca
from ..utils.mds import mds
from ._common import parser


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)

    # --- MDS: recover a planar configuration from pairwise distances --------
    true2d = rng.uniform(-1, 1, (200, 2)).astype(np.float32)
    d = np.linalg.norm(true2d[:, None] - true2d[None, :], axis=-1)
    res = mds(torch.as_tensor(d, device=dev), max_dim=6, estimate_dim=True)
    emb = res.embedding.cpu().numpy()[:, : int(res.used_dims)]
    d_emb = np.linalg.norm(emb[:, None] - emb[None, :], axis=-1)
    print(
        f"MDS: eigengap picked dim {int(res.used_dims)} (true 2); "
        f"distance-matrix RMS error {np.sqrt(((d_emb - d) ** 2).mean()):.2e}"
    )

    # --- PCA: project/reconstruct an elongated cloud ------------------------
    basis = np.array([[3, 0, 0], [0, 0.5, 0], [0, 0, 0.05]], np.float32)
    cloud = rng.standard_normal((5000, 3)).astype(np.float32) @ basis
    cloud_t = torch.as_tensor(cloud, device=dev)
    pca = fit_pca(cloud_t)
    print(
        "PCA eigenvalues (→ 9 : 0.25 : 0.0025):",
        np.round(pca.eigenvalues.cpu().numpy(), 4),
    )
    proj2 = pca.project(cloud_t, 2)
    rec = pca.reconstruct(proj2)
    err = np.linalg.norm(rec.cpu().numpy() - cloud, axis=1)
    print(
        f"project→2D→reconstruct residual: mean {err.mean():.4f} "
        f"(≈ the dropped component's σ = 0.05)"
    )
    det = float(np.linalg.det(pca.eigenvectors.cpu().numpy()))
    print(f"basis determinant {det:+.3f} (right-handed by construction)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
