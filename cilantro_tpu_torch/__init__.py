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
and normals, the scanned drivers, the non-rigid warp, the SLAM backend,
multi-stream fusion, estimation and clustering, PLY I/O, the utilities
and visualization, and the multi-device paths on torch.distributed):

core            ``Transform`` and its ops (the closest rotation through a
                kernel, ``csrc/rotation_kernels.cu``), ``CameraIntrinsics``, depth →
                points (+normals), the z-buffer, ``PointCloud`` (with
                kNN / radius normals, PLY files), grids, covariance and MCD,
                normal estimation, PCA, the pair evaluators, the
                wide-row gather kernel (``core/coalesced.py``)
neighbors       exact 1-NN and the nn1 kernels (``neighbors/fused_nn.py``),
                exact kNN and radius search with the two kNN kernels
                (``neighbors/fused_knn.py``), the grid radius search and
                the ``knn_search`` / ``radius_search`` API
correspondence  nearest-neighbour (one way, both ways, oracle, the
                combined-metric combiner) and projective correspondences
registration    the 2-D and 3-D estimators, ``icp``, ``icp_multires``,
                ``icp_projective``; the non-rigid warp fields on an
                embedded deformation graph or per point, single and
                B-stream (``warp_field.py``, ``warp_field_batched.py``)
slam            the splat kernels (``slam/splat.py``), splat fusion
                (``slam/splat_fusion.py``), pool fusion
                (``slam/fusion.py``), ``run_fusion_sequence`` with
                checkpoints (``slam/checkpoint.py``), ``ate_rmse`` and
                the synthetic sequences (``slam/driver.py``), both
                pipelines' scanned drivers, one step captured in a CUDA
                graph and replayed (``slam/scan.py``), and keyframe SLAM:
                keyframes and loop closures, the pose graph, single-device
                Schur bundle adjustment, its landmark-sharded form and
                ``run_slam``
model_estimation  batched RANSAC: planes and rigid / affine transforms
clustering      k-means, mean shift, connected components, spectral
                clustering (dense and on a kNN graph, with LOBPCG)
spatial         convex polytopes and space regions (hulls on the host,
                containment on the device)
utils           PLY and matrix I/O, nearest-neighbour graph matrices,
                classical MDS, colour maps, timers, roofline lines (H100
                peaks), two-count op timing, profiling on torch.profiler
viz             renders through the z-buffer, PNG artefacts (matplotlib,
                optional), the standalone WebGL viewer and the fusion
                drivers' live snapshot hook
parallel        the ``(points, map)`` mesh of ranks on torch.distributed
                (NCCL, or gloo), sharded and ring ICP, the ring NN,
                map-sharded fusion, point-sharded warp fields, the
                runtime entry and the collectives they use
native          the CUDA kernels' nvcc build, and the host C++ (the PLY
                codec and the single-core CPU baselines, ``csrc/host/``)
                built with g++
interop         build port state (clouds, maps, deformation graphs,
                keyframe graphs, BA problems, a rank's shards) from the
                JAX package's leaves (numpy)
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


def on_device(x, device=None, dtype=None):
    """``x`` as a tensor for an entry point. A tensor keeps its own device
    unless ``device`` names another; anything else (numpy, lists) goes to
    ``device``, the card by default. ``dtype`` converts; None stays None."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        dev = x.device if device is None else resolve_device(device)
        return x.to(device=dev, dtype=dtype)
    return torch.as_tensor(x, dtype=dtype, device=resolve_device("cuda" if device is None else device))
