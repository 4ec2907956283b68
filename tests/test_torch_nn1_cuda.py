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

from cilantro_tpu_torch.neighbors import fused_nn as nn

TQ, TM = 128, 256


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
    before = dict(nn.launch_counts)
    out = fn()
    torch.cuda.synchronize()
    after = dict(nn.launch_counts)
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == name) for k in after
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
    before = nn.launch_counts["nn1_fused"]
    lin, tr = fwd(*args)
    assert nn.launch_counts["nn1_fused"] > before
    # The toy registration stops unconverged after 10 iterations, so float32
    # reduction order shows through (it moves with the CPU thread count
    # alone); a wrong nearest neighbour moves it by far more than 1e-3.
    fwd_cpu, args_cpu = entry(device="cpu")
    lin_c, tr_c = fwd_cpu(*args_cpu)
    assert torch.allclose(lin.cpu(), lin_c, atol=1e-3)
    assert torch.allclose(tr.cpu(), tr_c, atol=1e-3)
