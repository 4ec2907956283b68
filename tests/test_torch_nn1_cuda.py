"""Each CUDA nn1 kernel against its plain PyTorch version, on the card.

Kernel and plain version sum the same 8 products in the same order, so
distances must agree bit for bit (compared as int32 views) and indices
exactly, ties included. The tests skip on a machine without a CUDA device.
This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_nn1_cuda.py
"""

import numpy as np
import pytest
import torch

from cilantro_tpu_torch import native
from cilantro_tpu_torch.neighbors import fused_nn as nn

TQ, TM = 128, 256
NN1_KERNELS = ("nn1_fused", "nn1_masked", "nn1_compact")


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
    other nn1 kernel."""
    before = {k: native.launch_counts[k] for k in NN1_KERNELS}
    out = fn()
    torch.cuda.synchronize()
    assert {k: native.launch_counts[k] - before[k] for k in NN1_KERNELS} == {
        k: int(k == name) for k in NN1_KERNELS
    }
    return out


def _operands(dev, seed=0, qn=1000, mn=3000):
    """Augmented rows with exact query copies (distance-0 ties), repeated
    keys (index ties) and 10% masked keys."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-0.5, 0.5, (qn, 3)).astype(np.float32)
    k = rng.uniform(-0.5, 0.5, (mn, 3)).astype(np.float32)
    k[:100] = q[:100]
    k[500:700] = k[:200]
    kv = torch.from_numpy(rng.random(mn) < 0.9)
    qp, kp = nn._augment(torch.from_numpy(q), torch.from_numpy(k), kv, TQ, TM)
    n_qt, n_mt = qp.shape[0] // TQ, kp.shape[0] // TM
    mask = rng.random((n_qt, n_mt)) < 0.4
    mask[np.arange(n_qt), rng.integers(0, n_mt, n_qt)] = True
    return qp.to(dev), kp.to(dev), torch.from_numpy(mask).to(dev)


@pytest.mark.cuda
def test_fused_kernel_matches_plain(cuda):
    qp, kp, _ = _operands(cuda)
    out = _launched("nn1_fused", lambda: nn.fused_rows(qp, kp))
    _same(out, nn.fused_rows_plain(qp, kp))


@pytest.mark.cuda
def test_masked_kernel_matches_plain(cuda):
    qp, kp, mask = _operands(cuda, seed=1)
    m32 = mask.to(torch.int32)
    out = _launched("nn1_masked", lambda: nn.masked_rows(qp, kp, m32, tile_q=TQ, tile_m=TM))
    _same(out, nn.masked_rows_plain(qp, kp, m32, TQ, TM))


@pytest.mark.cuda
def test_compact_kernel_and_fallback_match_plain(cuda):
    qp, kp, mask = _operands(cuda, seed=2)
    want = nn.masked_rows_plain(qp, kp, mask.to(torch.int32), TQ, TM)
    count = int(mask.sum())
    for budget, route in ((mask.numel(), "nn1_compact"), (count, "nn1_compact"), (count - 1, "nn1_masked")):
        d, i = _launched(
            route, lambda: nn._nn1_compact(qp, kp, mask, budget=budget, tile_q=TQ, tile_m=TM)
        )
        _same((d.reshape(-1), i.reshape(-1)), want)
    qt, kt, fl = nn._compact_list(mask, mask.numel())
    _same(
        nn.compact_rows(qp, kp, qt, kt, fl, tile_q=TQ, tile_m=TM),
        nn.compact_rows_plain(qp, kp, qt, kt, fl, TQ, TM),
    )


@pytest.mark.cuda
def test_planned_pass_on_card_matches_cpu(cuda):
    """The whole pruned pass (plan, masks, budget rule, kernel, gates,
    unpermute) gives the CPU run's answer bit for bit."""
    rng = np.random.default_rng(3)
    k = rng.uniform(-0.3, 0.3, (5000, 3)).astype(np.float32)
    q = (k[::2] + rng.normal(0, 3e-3, (2500, 3))).astype(np.float32)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        plan = nn.make_nn1_prune_plan(
            torch.from_numpy(k).to(dev), 0.02, torch.from_numpy(q).to(dev), tile_q=TQ, tile_m=TM
        )
        outs.append(nn.nn1_pruned_planned(torch.from_numpy(q).to(dev), plan))
    _same(outs[0], outs[1])


@pytest.mark.cuda
def test_kernels_refuse_what_they_cannot_take(cuda):
    qp, kp, mask = _operands(cuda)
    with pytest.raises(ValueError, match="multiple of 128"):
        nn.masked_rows(qp, kp, torch.ones((16, 12), dtype=torch.int32, device=cuda), tile_q=64, tile_m=TM)
    with pytest.raises(ValueError, match="contiguous"):
        nn.fused_rows(qp, kp.t().contiguous().t())
    with pytest.raises(ValueError, match="several devices"):
        nn.fused_rows(qp, kp.cpu())


@pytest.mark.cuda
def test_entry_runs_the_fused_kernel(cuda):
    from cilantro_tpu_torch.entry import entry

    fwd, args = entry()
    before = native.launch_counts["nn1_fused"]
    lin, tr = fwd(*args)
    assert native.launch_counts["nn1_fused"] > before
    # The toy registration stops unconverged after 10 iterations, so float32
    # reduction order shows through (it moves with the CPU thread count
    # alone); a wrong nearest neighbour moves it by far more than 1e-3.
    fwd_cpu, args_cpu = entry(device="cpu")
    lin_c, tr_c = fwd_cpu(*args_cpu)
    assert torch.allclose(lin.cpu(), lin_c, atol=1e-3)
    assert torch.allclose(tr.cpu(), tr_c, atol=1e-3)


def _cloud_operands(dev, seed, dim, qn, mn, tq, tm, density=0.4):
    """Augmented ``dim``-D rows with exact query copies, repeated keys, 10%
    masked keys and -0.0 coordinates, and a tile mask that keeps at least
    one chunk per query tile."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-0.5, 0.5, (qn, dim)).astype(np.float32)
    k = rng.uniform(-0.5, 0.5, (mn, dim)).astype(np.float32)
    k[:50] = q[:50]
    k[300:400] = k[:100]
    q[50:60] = -0.0
    k[400:410] = -0.0
    kv = torch.from_numpy(rng.random(mn) < 0.9)
    qp, kp = nn._augment(torch.from_numpy(q), torch.from_numpy(k), kv, tq, tm)
    n_qt, n_mt = qp.shape[0] // tq, kp.shape[0] // tm
    mask = rng.random((n_qt, n_mt)) < density
    mask[np.arange(n_qt), rng.integers(0, n_mt, n_qt)] = True
    return qp.to(dev), kp.to(dev), torch.from_numpy(mask).to(dev)


def _both_routes(qp, kp, mask, tq, tm, terms):
    """The masked kernel and the compact kernel (through its wrapper) on one
    mask, each against the plain version."""
    m32 = mask.to(torch.int32)
    want = nn.masked_rows_plain(qp, kp, m32, tq, tm)
    got = _launched(
        "nn1_masked", lambda: nn.masked_rows(qp, kp, m32, tile_q=tq, tile_m=tm, terms=terms)
    )
    _same(got, want)
    d, i = _launched(
        "nn1_compact",
        lambda: nn._nn1_compact(qp, kp, mask, budget=mask.numel(), tile_q=tq, tile_m=tm, terms=terms),
    )
    _same((d.reshape(-1), i.reshape(-1)), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("tq", [128, 256, 384, 512])
def test_live_terms_and_block_fallbacks_match_plain(cuda, dim, tq):
    """D + 2 terms at every rows-a-thread choice: 4 rows at tile_q 512, 2 at
    256, 1 at 128 and 384."""
    qp, kp, mask = _cloud_operands(cuda, 10 + tq + dim, dim, 1700, 2600, tq, 256)
    _both_routes(qp, kp, mask, tq, 256, nn._live_terms(dim))
    assert nn.kernel_design["nn1_compact"]["rows_per_thread"] == {128: 1, 256: 2, 384: 1, 512: 4}[tq]


@pytest.mark.cuda
def test_long_run_beside_short_runs_matches_plain(cuda):
    """One query tile visits every key chunk, the others one each: the
    masked kernel's key splits and the compact kernel's items share the
    long tile's rows."""
    qp, kp, mask = _cloud_operands(cuda, 21, 3, 2048, 8192, 512, 256, density=0.0)
    mask[1] = True
    _both_routes(qp, kp, mask, 512, 256, 5)
    assert nn.kernel_design["nn1_masked"]["splits"] > 1


@pytest.mark.cuda
def test_over_budget_route_with_live_terms_matches_plain(cuda):
    qp, kp, mask = _cloud_operands(cuda, 22, 3, 1500, 3000, 256, 256)
    want = nn.masked_rows_plain(qp, kp, mask.to(torch.int32), 256, 256)
    d, i = _launched(
        "nn1_masked",
        lambda: nn._nn1_compact(qp, kp, mask, budget=int(mask.sum()) - 1, tile_q=256, tile_m=256, terms=5),
    )
    _same((d.reshape(-1), i.reshape(-1)), want)


@pytest.mark.cuda
def test_padding_query_block_matches_plain(cuda):
    """The last query tile of 384 rows holds 130 real rows, so its third
    block of 128 rows is all padding (zeros: distance 0 to every key, the
    first visited key wins)."""
    qp, kp, mask = _cloud_operands(cuda, 23, 3, 384 + 130, 2000, 384, 256)
    assert qp.shape[0] == 768 and not qp[640:].any()
    _both_routes(qp, kp, mask, 384, 256, 5)
    assert nn.kernel_design["nn1_compact"]["rows_per_thread"] == 1


@pytest.mark.cuda
def test_launches_do_not_sync(cuda):
    qp, kp, mask = _cloud_operands(cuda, 24, 3, 2000, 3000, 512, 256)
    m32 = mask.to(torch.int32)
    qt, kt, fl = nn._compact_list(mask, mask.numel())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        masked = nn.masked_rows(qp, kp, m32, tile_q=512, tile_m=256, terms=5)
        compact = nn.compact_rows(qp, kp, qt, kt, fl, tile_q=512, tile_m=256, terms=5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = nn.masked_rows_plain(qp, kp, m32, 512, 256)
    _same(masked, want)
    _same(compact, want)


@pytest.mark.cuda
def test_planned_2d_pass_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(25)
    k = rng.uniform(-0.3, 0.3, (6000, 2)).astype(np.float32)
    q = (k[::2] + rng.normal(0, 3e-3, (3000, 2))).astype(np.float32)
    outs = []
    nn.kernel_design.clear()
    for dev in (cuda, torch.device("cpu")):
        plan = nn.make_nn1_prune_plan(
            torch.from_numpy(k).to(dev), 0.02, torch.from_numpy(q).to(dev), tile_q=256, tile_m=TM
        )
        outs.append(nn.nn1_pruned_planned(torch.from_numpy(q).to(dev), plan))
    _same(outs[0], outs[1])
    # The pass took the compact kernel or, over its budget, the masked one.
    (design,) = nn.kernel_design.values()
    assert design["rows_per_thread"] == 2


@pytest.mark.cuda
def test_entry_iterations_lie_on_the_card(cuda):
    from unittest import mock

    import cilantro_tpu_torch.entry as entry_mod

    results = []
    real_icp = entry_mod.icp

    def keep(*args, **kwargs):
        results.append(real_icp(*args, **kwargs))
        return results[-1]

    fwd, args = entry_mod.entry()
    with mock.patch.object(entry_mod, "icp", keep):
        fwd(*args)
    assert results, "entry() did not call icp"
    res = results[-1]
    assert res.iterations.device == res.transform.linear.device
    assert res.iterations.device.type == "cuda"


def _fused_operands(dev, seed, dim, qn, mn, all_invalid=False):
    """``nn1_fused``'s rows for a ``dim``-D cloud: exact query copies,
    repeated keys, 10% masked keys (all if ``all_invalid``), -0.0
    coordinates and invalid queries at 1e30; queries padded as
    ``nn1_fused`` pads them, keys not at all."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-0.5, 0.5, (qn, dim)).astype(np.float32)
    k = rng.uniform(-0.5, 0.5, (mn, dim)).astype(np.float32)
    n = min(qn, mn) // 4
    k[:n] = q[:n]  # distance-0 ties
    k[n : 2 * n] = k[:n]  # repeated keys: ties to the smaller index
    q[-3:] = 1e30
    k[-1:] = -0.0
    kv = torch.from_numpy(rng.random(mn) < 0.9)
    if all_invalid:
        kv[:] = False
    qp, kp = nn._augment(torch.from_numpy(q), torch.from_numpy(k), kv, nn._fused_rows_multiple(qn), 1)
    return qp.to(dev), kp.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3, 5])
@pytest.mark.parametrize("qn", [128, 512, 4096])
@pytest.mark.parametrize("mn", [1, 130, 300, 4097])
def test_fused_kernel_splits_match_plain(cuda, dim, qn, mn):
    """One block, one 4-row block and the ``entry()`` shape; one key, keys
    below one stage (a single tail split) and a key count that is a
    multiple of nothing. One launch a call."""
    qp, kp = _fused_operands(cuda, 30 + dim + qn + mn, dim, qn, mn)
    terms = nn._live_terms(dim)
    got = _launched("nn1_fused", lambda: nn.fused_rows(qp, kp, terms=terms))
    _same(got, nn.fused_rows_plain(qp, kp))
    design = nn.kernel_design["nn1_fused"]
    assert design["rows_per_thread"] == {128: 1, 512: 4, 4096: 4}[qn]
    assert design["blocks"] == qn // (128 * design["rows_per_thread"]) * design["splits"]
    if mn <= 128:
        assert design["splits"] == 1
    if qn == 4096 and mn == 4097:
        assert design["splits"] > 1


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3])
def test_fused_kernel_all_keys_invalid_keeps_the_start(cuda, dim):
    qp, kp = _fused_operands(cuda, 40 + dim, dim, 512, 3000, all_invalid=True)
    d, i = _launched("nn1_fused", lambda: nn.fused_rows(qp, kp, terms=nn._live_terms(dim)))
    _same((d, i), nn.fused_rows_plain(qp, kp))
    assert (d[:509] == 3e38).all() and (i[:509] == 0).all()


@pytest.mark.cuda
def test_fused_launch_does_not_sync(cuda):
    qp, kp = _fused_operands(cuda, 42, 3, 4096, 4096)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = nn.fused_rows(qp, kp, terms=5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _same(got, nn.fused_rows_plain(qp, kp))


@pytest.mark.cuda
@pytest.mark.parametrize("qn", [100, 200, 1000])
def test_nn1_fused_on_card_matches_cpu(cuda, qn):
    """The whole wrapper (padding, live terms, clamp, gates) against its CPU
    run, which takes the plain version: the same bits."""
    rng = np.random.default_rng(qn)
    q = rng.uniform(-0.5, 0.5, (qn, 3)).astype(np.float32)
    k = rng.uniform(-0.5, 0.5, (2500, 3)).astype(np.float32)
    k[:50] = q[:50]
    qv, kv = rng.random(qn) < 0.9, rng.random(2500) < 0.9
    outs = [
        nn.nn1_fused(*(torch.from_numpy(a).to(dev) for a in (q, k)),
                     query_valid=torch.from_numpy(qv).to(dev), key_valid=torch.from_numpy(kv).to(dev))
        for dev in (cuda, torch.device("cpu"))
    ]
    _same(outs[0], outs[1])
