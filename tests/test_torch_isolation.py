"""The port stands alone: importing it loads neither JAX nor anything of
``cilantro_tpu``, and its entry points never fall back to the CPU when
CUDA is asked for and absent."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises
import cilantro_tpu_torch
for mod in pkgutil.walk_packages(cilantro_tpu_torch.__path__, "cilantro_tpu_torch."):
    __import__(mod.name)
loaded = sorted(
    name for name, mod in sys.modules.items()
    if mod is not None and (name.split(".")[0] in ("jax", "jaxlib", "cilantro_tpu"))
)
print("LOADED", loaded)
"""


def test_import_loads_no_jax_and_no_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_cuda_default_raises_without_cuda(monkeypatch):
    from cilantro_tpu_torch import resolve_device
    from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
    from cilantro_tpu_torch.slam import driver, splat_fusion

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    depths = [np.ones((32, 40), np.float32)] * 2
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        splat_fusion.run_splat_sequence(depths, CameraIntrinsics.kinect_640())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.ate_rmse([np.eye(4)] * 3, [np.eye(4)] * 3)
    assert resolve_device("cpu") == torch.device("cpu")


def test_icp_entry_points_raise_without_cuda(monkeypatch):
    from cilantro_tpu_torch import interop
    from cilantro_tpu_torch.core import containers
    from cilantro_tpu_torch.entry import entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
    pts = np.zeros((8, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        containers.from_numpy(pts)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        interop.point_cloud_from_numpy(pts)
    # icp runs where its tensors lie: a CPU call needs no card.
    fwd, args = entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
