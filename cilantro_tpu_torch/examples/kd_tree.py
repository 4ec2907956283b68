"""NN search demo (port of ``examples/kd_tree.py``; reference
``examples/kd_tree.cpp``): kNN / radius / kNN-in-radius on a 120k cloud,
with the grid-bucketed backend cross-checked against brute force and the
overflow flags on display.

The queries are the cloud's first 2,000 points and ``exclude_self`` drops
each one's own index, which the pruned route cannot do for a query set
other than the whole cloud (it raises). So the kNN and kNN-in-radius
searches ask for the unpruned route (``backend="brute"``: the full kNN
kernel on the card), the route the JAX script takes on the CPU.

Usage: python -m cilantro_tpu_torch.examples.kd_tree [cloud.ply] [--device cpu]
"""

from __future__ import annotations

import torch

from .. import resolve_device
from ..neighbors import knn_in_radius_search, knn_search, radius_search
from ._common import load_cloud, parser


def main(argv=None) -> int:
    args = parser(__doc__, cloud=True).parse_args(argv)
    dev = resolve_device(args.device)
    (pts, _, _), _ = load_cloud(args.cloud, args.points)
    pts_t = torch.as_tensor(pts, device=dev)
    q = pts_t[:2000]
    print(f"cloud: {len(pts)} points; querying with the first {q.shape[0]}")

    nb = knn_search(q, pts_t, 8, exclude_self=True, backend="brute")
    print(
        f"kNN k=8:          mean NN dist "
        f"{float(torch.sqrt(nb.distances[:, 0]).mean())*1e3:.2f} mm"
    )

    nb_r = radius_search(q, pts_t, 0.01, 32, exclude_self=True, backend="brute")
    print(
        f"radius 1 cm:      mean count {float(nb_r.counts().float().mean()):.1f}, "
        f"overflowed {int(nb_r.overflowed.sum())}/{q.shape[0]} "
        f"(max_results=32 truncation, reported honestly)"
    )

    nb_g = radius_search(q, pts_t, 0.01, 32, exclude_self=True, backend="grid")
    r_idx, r_mask, r_over = (t.cpu().numpy() for t in (nb_r.indices, nb_r.mask, nb_r.overflowed))
    g_idx, g_mask, g_over = (t.cpu().numpy() for t in (nb_g.indices, nb_g.mask, nb_g.overflowed))
    agree = 0
    for i in range(q.shape[0]):
        if r_over[i] or g_over[i]:
            agree += 1  # truncated: sets may differ, both flagged
            continue
        agree += set(r_idx[i][r_mask[i]].tolist()) == set(g_idx[i][g_mask[i]].tolist())
    print(f"grid backend:     {agree}/{q.shape[0]} queries agree with brute force")

    nb_kr = knn_in_radius_search(q, pts_t, 4, 0.005, exclude_self=True, backend="brute")
    print(
        f"kNN-in-radius:    k=4 within 5 mm -> mean count "
        f"{float(nb_kr.counts().float().mean()):.2f}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
