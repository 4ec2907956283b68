"""Each CUDA kNN kernel (and the probe's ``scale2``) against its plain
PyTorch version, on the card.

Kernel and plain version sum the same 8 products in the same order and
keep the same k lexicographically smallest ``(distance, position)`` pairs,
so distances must agree bit for bit (compared as int32 views) and indices
exactly, ties included. The tests skip on a machine without a CUDA device.
This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_knn_cuda.py
"""

import numpy as np
import pytest
import torch

from cilantro_tpu_torch import native
from cilantro_tpu_torch.neighbors import fused_knn as knn
from cilantro_tpu_torch.neighbors import fused_nn as nn

TQ, TM = 128, 256
KNN_KERNELS = ("knn_full", "knn_compact")


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _same(kernel_out, plain_out):
    (dk, ik), (dp, ip) = kernel_out, plain_out
    assert torch.equal(dk.cpu().view(torch.int32), dp.cpu().view(torch.int32))
    assert torch.equal(ik.cpu(), ip.cpu())


def _launched(name, fn):
    """Run ``fn`` and check that it launched kernel ``name`` once and no
    other kNN kernel."""
    before = {k: native.launch_counts[k] for k in KNN_KERNELS}
    out = fn()
    torch.cuda.synchronize()
    after = {k: native.launch_counts[k] - before[k] for k in KNN_KERNELS}
    assert after == {k: int(k == name) for k in KNN_KERNELS}
    return out


def _operands(dev, seed=0, qn=1000, mn=3000, same_cloud=False, invalid_queries=False, grid=False):
    """Augmented rows with exact copies (distance-0 ties), repeated keys
    (index ties), 10% masked keys and, if asked, queries at 1e30 (their
    ‖q‖² is inf: inf and NaN sums). ``grid``: points on an integer grid of
    side 8, so that most distances tie with many others."""
    rng = np.random.default_rng(seed)
    if grid:
        q = rng.integers(0, 8, (qn, 3)).astype(np.float32)
        k = q.copy() if same_cloud else rng.integers(0, 8, (mn, 3)).astype(np.float32)
    else:
        q = rng.uniform(-0.5, 0.5, (qn, 3)).astype(np.float32)
        k = q.copy() if same_cloud else rng.uniform(-0.5, 0.5, (mn, 3)).astype(np.float32)
    if not same_cloud:
        k[:100] = q[:100]
    n = len(k[500:700])
    k[500 : 500 + n] = k[:n]
    if invalid_queries:
        q[rng.random(qn) < 0.2] = 1e30
    kv = torch.from_numpy(rng.random(k.shape[0]) < 0.9)
    qp, kp = nn._augment(torch.from_numpy(q), torch.from_numpy(k), kv, TQ, TM)
    n_qt, n_mt = qp.shape[0] // TQ, kp.shape[0] // TM
    mask = rng.random((n_qt, n_mt)) < 0.4
    mask[np.arange(n_qt), rng.integers(0, n_mt, n_qt)] = True
    mask[-1] = False  # a query tile that no live entry names
    return qp.to(dev), kp.to(dev), torch.from_numpy(mask).to(dev)


# Each side of the kernels' register buckets (32 | 33: registers | device
# memory rows in the thread design, one | two registers a lane in the warp
# design, whose lists end at 1,024 slots: 513 takes all of them) and of the
# full kernel's key splits.
KS = [1, 12, 32, 33, 65, 200, 513]
# The full kernel's designs: None is the route's pick, the others forced
# through the internal launcher.
DESIGNS = [None, "thread", "warp"]


def _full(qp, kp, k, diag, design):
    """One launch of the full kernel in ``design`` (None: the route's)."""
    if design is None:
        return knn.knn_full_rows(qp, kp, k=k, exclude_diag=diag)
    plan = knn._full_plan(qp.shape[0], kp.shape[0], k, knn._sm_count(qp.device), design=design)
    return knn._full_launch(qp, kp, k, diag, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("diag", [False, True])
def test_full_kernel_matches_plain(cuda, k, diag, design):
    """1,001 query rows: not a multiple of the warp design's 4 queries a
    block nor of the thread design's 128 (the last row is padding, whose
    sums are all 0: a row of ties)."""
    qp, kp, _ = _operands(cuda, seed=k, same_cloud=diag)
    qp = qp[:1001]
    out = _launched("knn_full", lambda: _full(qp, kp, k, diag, design))
    _same(out, knn.knn_full_rows_plain(qp, kp, k, diag))


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["thread", "warp"])
@pytest.mark.parametrize("k", [1, 12, 33, 200])
@pytest.mark.parametrize("diag", [False, True])
def test_full_kernel_split_path_matches_plain(cuda, k, diag, design):
    """128 queries against 8,192 keys: too few query blocks, so either
    design splits the keys across blocks and merges the partial lists.
    Keys 0-99 are queries 0-99, so the diagonal drops their distance-0
    pairs."""
    qp, kp, _ = _operands(cuda, seed=20 + k, qn=128, mn=8192)
    assert knn._full_plan(qp.shape[0], kp.shape[0], k, knn._sm_count(qp.device), design=design)["splits"] > 1
    out = _launched("knn_full", lambda: _full(qp, kp, k, diag, design))
    _same(out, knn.knn_full_rows_plain(qp, kp, k, diag))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case", ["k 32 | 33", "k 1024 | 1025", "thread grid at | under its least", "warp walk under | at long"])
def test_full_route_each_side_of_its_thresholds(cuda, case):
    """The route's pick on each side of each threshold it uses (the
    design, and the warp design's warps a block), launched as routed and
    bit for bit against the plain version."""
    sms = knn._sm_count(cuda)
    if case == "k 32 | 33":
        sides = [(4096, 4096, 32, "thread"), (4096, 4096, 33, "warp")]
    elif case == "k 1024 | 1025":
        sides = [(1200, 1500, 1024, "warp"), (1200, 1500, 1025, "thread")]
    elif case == "thread grid at | under its least":
        at = knn._FULL_BLOCK * knn._THREAD_BLOCKS_PER_SM * sms
        sides = [(at, 1000, 12, "thread"), (at - knn._FULL_BLOCK, 1000, 12, "warp")]
    else:
        sides = [(601, knn._WARP_LONG_KEYS - 1, 40, "warp"), (601, knn._WARP_LONG_KEYS, 40, "warp")]
    for qn, mn, k, design in sides:
        qp, kp, _ = _operands(cuda, seed=qn + k, qn=qn, mn=mn)
        qp, kp = qp[:qn], kp[:mn]
        plan = knn.kernel_design("knn_full", qn, mn, k, sms=sms)
        assert plan["design"] == design
        if design == "warp":
            assert plan["queries_per_block"] == (knn._WARPS_LONG if mn >= knn._WARP_LONG_KEYS else knn._WARPS)
        out = _launched("knn_full", lambda: knn.knn_full_rows(qp, kp, k=k))  # noqa: B023
        _same(out, knn.knn_full_rows_plain(qp, kp, k))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [12, 65])
@pytest.mark.parametrize("diag", [False, True])
def test_compact_long_runs_split_into_parts_match_plain(cuda, k, diag):
    """Query tiles whose runs name more key chunks than one block takes
    (16,384 keys: 64 chunks of 256) are split into parts whose partial lists
    the last part merges; the other tiles keep one part."""
    qp, kp, _ = _operands(cuda, seed=40 + k, qn=36000 if diag else 512, mn=36000, same_cloud=diag)
    n_qt, n_mt = qp.shape[0] // TQ, kp.shape[0] // TM
    mask = torch.from_numpy(np.random.default_rng(k).random((n_qt, n_mt)) < 0.3).to(cuda)
    mask[0] = True  # 141 chunks: three parts
    mask[1, :70] = True  # at least 70: two parts
    qt, kt, fl = nn._compact_list(mask, mask.numel())
    items = knn._compact_items(qt, kt, fl, n_qt, TQ, TM, int(mask.sum()))[2]
    assert int(items[:, 3].max()) == 3
    _same(
        knn.knn_compact_rows(qp, kp, qt, kt, fl, k=k, tile_q=TQ, tile_m=TM, exclude_diag=diag),
        knn.knn_compact_rows_plain(qp, kp, qt, kt, fl, k, TQ, TM, diag),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("k", [12, 65])
@pytest.mark.parametrize("diag", [False, True])
def test_tie_heavy_grid_matches_plain(cuda, k, diag):
    """Integer-grid points: equal distances everywhere, straddling the full
    kernel's key splits (both designs) and the compact kernel's chunks."""
    qn = 4000 if diag else 256
    qp, kp, mask = _operands(cuda, seed=30 + k, qn=qn, mn=6000, same_cloud=diag, grid=True)
    for design in DESIGNS:
        _same(_full(qp, kp, k, diag, design), knn.knn_full_rows_plain(qp, kp, k, diag))
    qt, kt, fl = nn._compact_list(mask, mask.numel())
    _same(
        knn.knn_compact_rows(qp, kp, qt, kt, fl, k=k, tile_q=TQ, tile_m=TM, exclude_diag=diag),
        knn.knn_compact_rows_plain(qp, kp, qt, kt, fl, k, TQ, TM, diag),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("diag", [False, True])
def test_compact_kernel_matches_plain(cuda, k, diag):
    qp, kp, mask = _operands(cuda, seed=10 + k, same_cloud=diag)
    qt, kt, fl = nn._compact_list(mask, mask.numel())
    out = _launched(
        "knn_compact",
        lambda: knn.knn_compact_rows(qp, kp, qt, kt, fl, k=k, tile_q=TQ, tile_m=TM, exclude_diag=diag),
    )
    want = knn.knn_compact_rows_plain(qp, kp, qt, kt, fl, k, TQ, TM, diag)
    _same(out, want)
    # The unnamed query tile keeps the starting state.
    assert bool((out[0][-TQ:] == 3.0e38).all()) and bool((out[1][-TQ:] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [12, 200])
def test_compact_wrapper_and_its_full_fallback(cuda, k):
    qp, kp, mask = _operands(cuda, seed=3)
    full_mask = torch.ones_like(mask)  # every pair: the full pass visits the same set
    want = knn.knn_full_rows_plain(qp, kp, k)
    count = int(full_mask.sum())
    for budget, route in ((count, "knn_compact"), (count - 1, "knn_full")):
        out = _launched(
            route,
            lambda: knn._knn_compact(qp, kp, full_mask, k=k, budget=budget, tile_q=TQ, tile_m=TM),
        )
        _same(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [12, 65])
def test_compact_wrapper_reads_nothing_back(cuda, k):
    """Given its live count, the compact wrapper builds its work on the
    card without a host sync, and dead entries spread among the live ones
    (other tiles and chunks) are never visited."""
    qp, kp, mask = _operands(cuda, seed=50 + k)
    qt, kt, fl = nn._compact_list(mask, mask.numel())
    live = int(mask.sum())
    rng = np.random.default_rng(k)
    pick = torch.from_numpy(np.sort(rng.permutation(mask.numel())[:live])).to(cuda)
    spread = torch.isin(torch.arange(mask.numel(), device=cuda), pick)
    fl2 = torch.where(spread, 2, 0).to(torch.int32)
    qt2 = torch.from_numpy(rng.integers(0, mask.shape[0], mask.numel()).astype(np.int32)).to(cuda)
    kt2 = torch.from_numpy(rng.integers(0, mask.shape[1], mask.numel()).astype(np.int32)).to(cuda)
    qt2[pick], kt2[pick] = qt[:live], kt[:live]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = knn.knn_compact_rows(qp, kp, qt2, kt2, fl2, k=k, tile_q=TQ, tile_m=TM, max_live=live)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _same(out, knn.knn_compact_rows_plain(qp, kp, qt, kt, fl, k, TQ, TM))


@pytest.mark.cuda
def test_invalid_queries_match_plain(cuda):
    qp, kp, mask = _operands(cuda, seed=4, invalid_queries=True)
    for design in DESIGNS:
        for k in (12, 65):
            _same(_full(qp, kp, k, False, design), knn.knn_full_rows_plain(qp, kp, k))
    qt, kt, fl = nn._compact_list(mask, mask.numel())
    _same(
        knn.knn_compact_rows(qp, kp, qt, kt, fl, k=12, tile_q=TQ, tile_m=TM),
        knn.knn_compact_rows_plain(qp, kp, qt, kt, fl, 12, TQ, TM),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("exclude_self", [False, True])
def test_pruned_paths_on_card_match_cpu(cuda, exclude_self):
    """``knn_pruned`` and ``radius_search_pruned`` (sorts, rounds, budget
    rule, kernels, gates, unpermute) give the CPU run's answer bit for bit."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(-0.3, 0.3, (5000, 3)).astype(np.float32)
    valid = rng.random(5000) < 0.9
    outs = []
    for dev in (cuda, torch.device("cpu")):
        p, v = torch.from_numpy(pts).to(dev), torch.from_numpy(valid).to(dev)
        d, i = knn.knn_pruned(p, p, 10, query_valid=v, key_valid=v, exclude_self=exclude_self,
                              tile_q=TQ, tile_m=TM)
        dr, ir, over = knn.radius_search_pruned(p, p, 0.03, 8, query_valid=v, key_valid=v,
                                                exclude_self=exclude_self, tile_q=TQ, tile_m=TM)
        outs.append((d, i, dr, ir, over))
    for a, b in zip(*outs):
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
def test_grid_radius_normals_on_card_match_cpu(cuda):
    """``with_normals_radius`` at its default cap of 32 on a 9,000-point
    sheet 1.5 m away: ``radius_search`` sends CUDA tensors to the grid
    search (cap above 16), which launches no kNN kernel. The grid's
    distance blocks sum in another order on the card, so near-ties at the
    radius or the cap may swap a neighbour: validity equal on 99% of the
    points and |cos| ≥ 0.999 on 99% of those valid in both, as for the kNN
    normals."""
    from cilantro_tpu_torch.core.containers import from_numpy

    rng = np.random.default_rng(6)
    xy = rng.uniform(-0.3, 0.3, (9000, 2))
    z = 1.5 + 0.05 * np.sin(6 * xy[:, 0]) * np.cos(5 * xy[:, 1])
    pts = np.column_stack([xy, z]).astype(np.float32)
    before = {k: native.launch_counts[k] for k in KNN_KERNELS}
    card = from_numpy(pts, device=cuda).with_normals_radius(0.02)
    torch.cuda.synchronize()
    assert {k: native.launch_counts[k] for k in KNN_KERNELS} == before
    cpu = from_numpy(pts, device="cpu").with_normals_radius(0.02)
    vg, vc = card.valid.cpu(), cpu.valid
    assert float((vg == vc).float().mean()) >= 0.99 and int(vc.sum()) > 8000
    both = vg & vc
    cos = torch.abs(torch.sum(card.normals.cpu()[both] * cpu.normals[both], dim=-1))
    assert float((cos >= 0.999).float().mean()) >= 0.99


@pytest.mark.cuda
def test_kernels_refuse_what_they_cannot_take(cuda):
    qp, kp, mask = _operands(cuda)
    with pytest.raises(ValueError, match="at least 1"):
        knn.knn_full_rows(qp, kp, k=0)
    with pytest.raises(ValueError, match="contiguous"):
        knn.knn_full_rows(qp, kp.t().contiguous().t(), k=4)
    with pytest.raises(ValueError, match="several devices"):
        knn.knn_full_rows(qp, kp.cpu(), k=4)
    qt, kt, fl = nn._compact_list(mask, mask.numel())
    with pytest.raises(ValueError, match="multiple of 128"):
        knn.knn_compact_rows(qp, kp, qt, kt, fl, k=4, tile_q=64, tile_m=TM)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ((4,), (4 * 256 * 2 + 4,), (4 * 256 * 4 + 4,), (1000, 128),
                                   (53760, 128)))
def test_scale2_kernel_matches_plain(shape, cuda):
    """Sizes that leave a partial last block for 1, 2 and 4 float4 words
    a thread (4 floats; 2 or 4 blocks of 256 × 1 and one word), a whole
    number of blocks (1000 × 128) and the probe's (CAP/8, 128) view."""
    from cilantro_tpu_torch.tools import wide_row_probe as probe

    x = torch.randn(shape, device=cuda)
    x.view(-1)[:4] = torch.tensor([float("inf"), float("nan"), -0.0, 3e38])
    before = native.launch_counts["scale2"]
    out = probe.scale2(x)
    torch.cuda.synchronize()
    assert native.launch_counts["scale2"] == before + 1
    assert torch.equal(out.view(torch.int32), probe.scale2_plain(x).view(torch.int32))
    with pytest.raises(ValueError, match="divisible by 4"):
        probe.scale2(torch.ones(6, device=cuda))
