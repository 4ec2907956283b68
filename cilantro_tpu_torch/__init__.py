"""cilantro-tpu-torch: the PyTorch + CUDA port of ``cilantro_tpu``.

The package mirrors the JAX package's layout (``core/``, ``registration/``,
``slam/``) so that each module's counterpart is easy to find. It imports
``torch`` and numpy only: never ``jax`` and nothing of ``cilantro_tpu``.
The JAX package stays the reference; the tests hold every ported function
against it on the CPU.

Every TPU (Pallas) kernel on a ported path is a CUDA C++ kernel under
``csrc/`` (built with ``nvcc`` for ``sm_90a`` at first CUDA use, see
:mod:`.native`) with a plain PyTorch version beside it in the same module.
The wrapper runs the plain version only for CPU tensors; for a CUDA tensor
it launches the kernel or raises.

Ported so far (splat fusion, rigid ICP, pool fusion, neighbour engines
and normals, the scanned drivers, the non-rigid warp):

core            ``Transform`` and its ops (the closest rotation through a
                kernel, ``csrc/rotation_kernels.cu``), ``CameraIntrinsics``, depth →
                points (+normals), the z-buffer, ``PointCloud`` (with
                kNN / radius normals), grids, covariance and MCD,
                normal estimation, the wide-row gather kernel
                (``core/coalesced.py``)
neighbors       exact 1-NN and the nn1 kernels (``neighbors/fused_nn.py``),
                exact kNN and radius search with the two kNN kernels
                (``neighbors/fused_knn.py``), the grid radius search and
                the ``knn_search`` / ``radius_search`` API
correspondence  nearest-neighbour and projective correspondences
registration    the 3-D estimators, ``icp``, ``icp_multires``,
                ``icp_projective``; the non-rigid warp fields on an
                embedded deformation graph or per point, single and
                B-stream (``warp_field.py``, ``warp_field_batched.py``)
slam            the splat kernels (``slam/splat.py``), splat fusion
                (``slam/splat_fusion.py``), pool fusion
                (``slam/fusion.py``), ``run_fusion_sequence``,
                ``ate_rmse`` and ``synthetic_sequence``
                (``slam/driver.py``), and both pipelines' scanned
                drivers, one step captured in a CUDA graph and replayed
                (``slam/scan.py``)
interop         build port state (clouds, maps, deformation graphs) from
                the JAX package's leaves (numpy)
tools           the wide-row probe and its ``scale2`` kernel
"""

__version__ = "0.1.0"

import torch

# Geometry is conditioning-sensitive (normal equations, SO(3) projections):
# keep TF32 out of every float32 product, as ``cilantro_tpu`` pins matmul
# precision to "highest". A TF32 JᵀJ would move the poses.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for and the
    machine has none. Nothing in the port falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
