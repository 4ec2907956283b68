"""Mean-shift clustering (port of ``examples/mean_shift.py``; reference
``examples/mean_shift.cpp``): mode seeking on a mixture of Gaussian blobs,
flat vs Gaussian kernel.

Usage: python -m cilantro_tpu_torch.examples.mean_shift [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..clustering import mean_shift
from ._common import parser


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    centers = np.array(
        [[0.0, 0.0, 0.0], [1.5, 0.2, -0.3], [-0.4, 1.3, 0.8], [0.9, -1.1, 1.2]]
    )
    pts = np.concatenate(
        [c + rng.normal(0, 0.12, (300, 3)) for c in centers]
    ).astype(np.float32)
    pts_t = torch.as_tensor(pts, device=dev)

    for kernel in ("flat", "gaussian"):
        res = mean_shift(pts_t, 0.5, kernel=kernel)
        labels = res.labels.cpu().numpy()
        modes = res.modes.cpu().numpy()
        n_modes = int(res.num_clusters)
        # Match found modes to true centers.
        found = modes[:n_modes]
        err = [
            np.linalg.norm(found - c, axis=1).min() for c in centers
        ]
        true = np.repeat(np.arange(4), 300)
        purity = sum(
            np.unique(labels[true == t], return_counts=True)[1].max()
            for t in range(4)
        )
        print(
            f"mean shift [{kernel:8s}]: {n_modes} modes "
            f"(true 4), max mode error {max(err)*1e3:.1f} mm, "
            f"purity {purity}/1200"
        )

    # Large-N path: capped radius neighbourhoods + sparse mode merge (same
    # result here; scales past the dense path's (S, N) memory ceiling).
    res = mean_shift(pts_t, 0.5, max_neighbors=512)
    print(
        f"mean shift [capped  ]: {int(res.num_clusters)} modes "
        f"(true 4), {int(res.iterations)} iterations"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
