"""The estimation and clustering slice on the card: the kernels its
searches and fits launch, bit for bit against their plain versions on the
inputs of their calls at this slice's shapes, and its entry points card
against the port's own CPU run on one set of draws.

Kernels (each call recorded, then replayed through the wrapper and the
plain version): the fused nn1 kernel in ``find_nn_correspondences_bidirectional``
(both directions), the full and the compact kNN kernels in ``knn_search``
(below and above 2²⁶ pairs), the compact one in capped ``mean_shift``
(R = 16) and the rotation kernel in ``ransac_transform``'s 1,024 minimal
fits. Card and CPU sum in other orders: RANSAC's best hypothesis and its
counts within 0.1% of N, k-means the same iterations, centroids within
1e-4 and ≥ 99.9% of labels, components the same count and ≥ 99.9% of
labels. The tests skip on a machine without a CUDA device. This file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_estimation_cuda.py
"""

import contextlib
import importlib
from unittest import mock

import numpy as np
import pytest
import torch

from cilantro_tpu_torch.clustering import connected_components, edge_mask_from_evaluator, mean_shift
from cilantro_tpu_torch.core import transforms as tt
from cilantro_tpu_torch.correspondence.search import find_nn_correspondences_bidirectional
from cilantro_tpu_torch.model_estimation import ransac as rs
from cilantro_tpu_torch.neighbors import fused_knn, fused_nn, knn_search
from cilantro_tpu_torch.registration import transform_estimation as te

km = importlib.import_module("cilantro_tpu_torch.clustering.kmeans")

# (module, wrapper, plain version of the same arguments)
WRAPPERS = {
    "nn1_fused": (fused_nn, "fused_rows", lambda qp, kp, **kw: fused_nn.fused_rows_plain(qp, kp)),
    "knn_full": (fused_knn, "knn_full_rows",
                 lambda qp, kp, k, exclude_diag=False: fused_knn.knn_full_rows_plain(qp, kp, k, exclude_diag)),
    "knn_compact": (fused_knn, "knn_compact_rows",
                    lambda qp, kp, qt, kt, fl, k, tile_q, tile_m, exclude_diag=False, **kw:
                    fused_knn.knn_compact_rows_plain(qp, kp, qt, kt, fl, k, tile_q, tile_m, exclude_diag)),
    "project_to_rotation": (te, "project_to_rotation", tt.project_to_rotation_plain),
}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@contextlib.contextmanager
def _recorded(calls):
    """Every wrapper of ``WRAPPERS`` appends its arguments to ``calls``."""
    with contextlib.ExitStack() as stack:
        for name, (mod, attr, _) in WRAPPERS.items():
            def rec(*args, _real=getattr(mod, attr), _name=name, **kwargs):
                calls.setdefault(_name, []).append((args, kwargs))
                return _real(*args, **kwargs)

            stack.enter_context(mock.patch.object(mod, attr, rec))
        yield calls


def _hold(calls, name):
    """Each recorded call of ``name``: wrapper and plain version, the same bits."""
    mod, attr, plain = WRAPPERS[name]
    assert calls.get(name), f"{name} never launched"
    for args, kwargs in calls[name]:
        got, want = getattr(mod, attr)(*args, **kwargs), plain(*args, **kwargs)
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        for g, w in zip(got, want):
            assert torch.equal(g.contiguous().view(torch.int32), w.contiguous().view(torch.int32)), name


def _surface(n, seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    z = (0.2 * np.sin(1.5 * xy[:, 0]) * np.cos(1.5 * xy[:, 1])).astype(np.float32)
    return np.column_stack([xy, z]) * np.float32(0.36)


@pytest.mark.cuda
def test_bidirectional_fused_nn1_is_bit_exact(cuda):
    a = torch.as_tensor(_surface(12_000), device=cuda)
    b = a + 0.003
    calls = {}
    with _recorded(calls):
        corr = find_nn_correspondences_bidirectional(a, b)
    assert len(calls["nn1_fused"]) == 2  # one a direction
    _hold(calls, "nn1_fused")
    cpu = find_nn_correspondences_bidirectional(a.cpu(), b.cpu())
    assert float((corr.dst_idx.cpu() == cpu.dst_idx).float().mean()) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("n, kernel", [(3_000, "knn_full"), (20_000, "knn_compact")])
def test_knn_search_kernels_are_bit_exact(cuda, n, kernel):
    pts = torch.as_tensor(_surface(n, 1), device=cuda)
    calls = {}
    with _recorded(calls):
        knn_search(pts, pts, 8, exclude_self=True)
    _hold(calls, kernel)


@pytest.mark.cuda
def test_capped_mean_shift_compact_knn_is_bit_exact(cuda):
    pts = torch.as_tensor(_surface(12_000, 2), device=cuda)
    calls = {}
    with _recorded(calls):
        res = mean_shift(pts, 0.02, max_neighbors=16, max_iterations=5)
    assert bool(res.overflowed)
    _hold(calls, "knn_compact")


@pytest.mark.cuda
def test_ransac_transform_rotation_kernel_is_bit_exact(cuda):
    rng = np.random.default_rng(3)
    src = rng.standard_normal((5_000, 3)).astype(np.float32)
    dst = src[:, [1, 0, 2]] * np.float32([-1, 1, 1]) + 0.1
    dst[:1_500] = rng.uniform(-2, 2, (1_500, 3))
    calls = {}
    with _recorded(calls):
        tf, res = rs.ransac_transform(torch.Generator(device=cuda).manual_seed(0), torch.as_tensor(src, device=cuda),
                                      torch.as_tensor(dst, device=cuda), 0.02, num_hypotheses=1024)
    assert [a[0].shape for a, _ in calls["project_to_rotation"]] == [(1024, 3, 3), (3, 3)]
    _hold(calls, "project_to_rotation")
    assert int(res.num_inliers) == 3_500


@pytest.mark.cuda
def test_estimation_card_matches_cpu(cuda):
    """RANSAC and k-means on one set of card draws, card against CPU."""
    pts = torch.as_tensor(_surface(8_000, 4), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    scores = torch.rand((128, 8_000), generator=gen, device=cuda)
    gumbel = km._gumbel_from_uniform(torch.rand((16, 8_000), generator=gen, device=cuda))
    tol = 1e-3 * 8_000
    for dev in ("card", "cpu"):
        on = (lambda x: x) if dev == "card" else (lambda x: x.cpu())
        plane, pres = rs._ransac_plane_from_scores(on(scores), on(pts), 0.01)
        tf, tres = rs._ransac_transform_from_scores(on(scores), on(pts), on(pts + 0.05), 0.02)
        kmr = km._kmeans_from_draws(on(gumbel), on(pts), 16)
        if dev == "card":
            card = (pres, tres, kmr)
    for g, c in ((card[0], pres), (card[1], tres)):
        assert int(torch.argmax(g.hypothesis_inliers)) == int(torch.argmax(c.hypothesis_inliers))
        assert int((g.hypothesis_inliers.cpu() - c.hypothesis_inliers).abs().max()) <= tol
    assert int(card[2].iterations) == int(kmr.iterations)
    assert float((card[2].centroids.cpu() - kmr.centroids).abs().max()) <= 1e-4
    assert float((card[2].labels.cpu() == kmr.labels).float().mean()) >= 0.999


@pytest.mark.cuda
def test_components_card_matches_cpu(cuda):
    pts = _surface(8_000, 5)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        p = torch.as_tensor(pts, device=dev)
        nb = knn_search(p, p, 8, exclude_self=True)
        out[dev.type] = connected_components(nb, edge_mask=edge_mask_from_evaluator(nb, p, max_distance=0.012))
    g, c = out["cuda"], out["cpu"]
    assert int(g.num_components) == int(c.num_components) > 1
    gl, cl = g.labels.cpu().numpy(), c.labels.numpy()
    agree = sum(np.bincount(cl[gl == lab] + 1).max() for lab in np.unique(gl)) / len(gl)
    assert agree >= 0.999
