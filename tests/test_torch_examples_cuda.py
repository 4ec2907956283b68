"""An example that reaches the nn1 kernels (``rigid_icp``: the compact
kernel on both ``icp_multires`` levels) on the card against the same
module on the CPU: the printed transform within 1e-4. Skips without a
CUDA device. This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_examples_cuda.py
"""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

from cilantro_tpu_torch.examples import rigid_icp

NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's card paths have no CPU mode")
    return torch.device("cuda")


def _estimated(device):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert rigid_icp.main(["--points", "20000", "--device", device]) == 0
    text = buf.getvalue()
    rows = text.split("ESTIMATED transform:", 1)[1].split("]]", 1)[0]
    err = float(NUMBER.findall(text.split("max abs error:", 1)[1])[0])
    return np.array([float(x) for x in NUMBER.findall(rows)]).reshape(4, 4), err


@pytest.mark.cuda
def test_rigid_icp_example_card_matches_cpu(cuda):
    from cilantro_tpu_torch.neighbors import fused_nn

    fused_nn.reset_launch_counts()
    card, err = _estimated("cuda")
    assert fused_nn.launch_counts["nn1_compact"] > 0
    cpu, _ = _estimated("cpu")
    np.testing.assert_allclose(card, cpu, rtol=0, atol=1e-4)
    assert err < 1e-3
