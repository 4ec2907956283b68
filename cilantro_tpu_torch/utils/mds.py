"""Classical multidimensional scaling (port of ``cilantro_tpu/utils/mds.py``):
square the distances, double-centre the Gram matrix, take the top
eigenpairs (``torch.linalg.eigh``, dense) and embed as ``V·√Λ``;
optionally the dimension at the largest eigengap."""

from __future__ import annotations

import dataclasses

import torch

from .. import on_device


@dataclasses.dataclass(frozen=True)
class MDSResult:
    embedding: torch.Tensor  # (N, max_dim), zero-padded beyond used_dims
    eigenvalues: torch.Tensor  # (max_dim,) descending
    used_dims: torch.Tensor  # int32 (eigengap estimate or requested dim)


def mds(
    distances,
    max_dim: int,
    *,
    squared: bool = False,
    estimate_dim: bool = False,
    device=None,
) -> MDSResult:
    """Embed an ``(N, N)`` symmetric distance matrix into ``max_dim``
    dimensions, on its device (numpy: ``device``, the card by default).
    ``estimate_dim`` keeps the dimensions up to the largest gap among the
    positive eigenvalues."""
    distances = on_device(distances, device, torch.float32)
    n = distances.shape[0]
    dev = distances.device
    d2 = distances if squared else distances * distances
    j = torch.eye(n, device=dev) - torch.full((n, n), 1.0 / n, device=dev)
    b = -0.5 * j @ d2 @ j  # double-centred Gram
    w, v = torch.linalg.eigh(b)  # ascending
    w = torch.flip(w, (0,))[:max_dim]
    v = torch.flip(v, (1,))[:, :max_dim]
    w_pos = torch.clamp(w, min=0.0)
    emb = v * torch.sqrt(w_pos)[None, :]
    if estimate_dim:
        gaps = w_pos[:-1] - w_pos[1:]
        used = torch.argmax(gaps).to(torch.int32) + 1
        emb = torch.where(torch.arange(max_dim, device=dev)[None, :] < used, emb, 0.0)
    else:
        used = torch.tensor(max_dim, dtype=torch.int32, device=dev)
    return MDSResult(embedding=emb, eigenvalues=w_pos, used_dims=used)
