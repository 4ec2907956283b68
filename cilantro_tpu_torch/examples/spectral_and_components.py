"""Spectral clustering + connected components (port of
``examples/spectral_and_components.py``; reference
``examples/spectral_clustering.cpp`` + ``connected_component_extraction.cpp``):
three Laplacians with eigengap model selection, and normal-similarity
connected components on a cloud.

The JAX script draws LOBPCG's start from ``jax.random.PRNGKey(0)``; here
it comes from a ``torch.Generator`` seeded with 0. Its similarity gate
(neighbours within 2 cm and normals within 30°) is a lambda passed where
``edge_mask_from_evaluator`` takes the points, so no gate applies there;
here the evaluator's own ``max_distance`` and ``max_normal_angle`` gates
apply it.

Usage: python -m cilantro_tpu_torch.examples.spectral_and_components [cloud.ply] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..clustering import connected_components, edge_mask_from_evaluator, spectral_clustering
from ..neighbors import knn_search
from ..utils.graph import function_value_dense
from ._common import generator, load_cloud, parser


def main(argv=None) -> int:
    args = parser(__doc__, cloud=True).parse_args(argv)
    dev = resolve_device(args.device)

    # --- spectral clustering on three concentric rings ----------------------
    rng = np.random.default_rng(0)
    pts2 = []
    for r in (1.0, 3.0, 5.0):
        th = rng.uniform(0, 2 * np.pi, 200)
        pts2.append(
            np.column_stack([r * np.cos(th), r * np.sin(th)])
            + rng.normal(0, 0.05, (200, 2))
        )
    rings = torch.as_tensor(np.concatenate(pts2), dtype=torch.float32, device=dev)
    nb = knn_search(rings, rings, 12, exclude_self=True)
    aff = function_value_dense(nb, lambda d: torch.exp(-d / (2 * 0.4**2)), symmetrize=True)
    true = np.repeat(np.arange(3), 200)
    for kind in ("unnormalized", "normalized", "random_walk"):
        est = spectral_clustering(
            generator(0, dev), aff, num_clusters=None, kind=kind
        )
        res = spectral_clustering(generator(0, dev), aff, 3, kind=kind)
        labels = res.labels.cpu().numpy()
        # Purity: each true ring should map to one cluster.
        purity = 0
        for t in range(3):
            vals, counts = np.unique(labels[true == t], return_counts=True)
            purity += counts.max()
        print(
            f"spectral [{kind:12s}]: eigengap estimate "
            f"{int(est.num_clusters)} (reference heuristic), k=3 purity "
            f"{purity}/600"
        )

    # --- connected components on a cloud ------------------------------------
    (pts, nrm, _), _ = load_cloud(args.cloud, args.points)
    sel = slice(0, len(pts), 8)  # subsample for the dense demo
    p = torch.as_tensor(pts[sel], device=dev)
    n = torch.as_tensor(nrm[sel], device=dev)
    nb = knn_search(p, p, 10, exclude_self=True)
    # Similarity gate: neighbours within 2 cm AND normals within 30°
    # (the reference's NormalsProximityEvaluator composition).
    edge_ok = edge_mask_from_evaluator(nb, p, n, max_distance=0.02, max_normal_angle=np.deg2rad(30.0))
    cc = connected_components(nb, edge_mask=edge_ok, min_size=50)
    sizes = cc.sizes.cpu().numpy()
    sizes = np.sort(sizes[sizes > 0])[::-1]
    print(
        f"connected components ({p.shape[0]} pts): {len(sizes)} segments ≥ 50 "
        f"pts; largest {sizes[:5].tolist()}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
