#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``cilantro_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``
(``/usr/local/cuda`` or on ``PATH``). It imports nothing of JAX. Phases,
in order; any failure raises and exits non-zero without the final line:

1. build the CUDA kernels from ``cilantro_tpu_torch/csrc/`` and phase
   37's gather variants (one ``nvcc`` per library, all at once, all
   finished before anything is timed);
2. hold each kernel against its plain PyTorch version on the card at the
   shapes splat fusion gives it at 640×480 (bit for bit: they are pure
   selects), and time kernel and plain version (CUDA events, median of 25
   runs after warm-up, launches queued behind a sleep kernel so that host
   enqueue time is not counted) beside the byte bound at 3.35 TB/s;
   ``splat_argmin2`` and ``flow_select_rows`` with their design records
   (the tile a block elects; pixels a thread, decode, store width) and the
   previous design's time on the case;
3. run splat fusion, the headline pipeline, through its entry point on 16
   synthetic 640×480 frames (radius 4, margin 16): launch counts, ms/frame,
   frames/s, ATE against ground truth (< 2e-3 m); each of the three splat
   kernels on the inputs of its last call (recorded on the way), bit for
   bit against its plain version and timed as in phase 2 beside its byte
   bound and, for the two redesigned ones, the previous design's time;
   the rotation kernel (``project_to_rotation``, one launch a GN
   iteration: launches equal to the window reads) bit for bit against its
   plain version on the matrix of its last call and on 4096 random ones,
   timed beside its byte bound and the SVD route it replaced (host clock:
   that route syncs); then a per-stage time split and a profiler window
   (informational);
4. run the first 4 frames through the same entry point on the CPU (the
   plain versions) and require the poses to agree within 1e-4 m / 1e-4 rad;
5. hold each nn1 kernel against its plain version on the card, bit for bit:
   the fused kernel (D + 2 terms, rows padded as ``nn1_fused`` pads them)
   at 4096 × 4096 (the ``entry()`` pair) and 32768 × 32768 (the coarse ICP
   level), each with its design record and the previous design's time;
   the compact and masked kernels (D + 2 terms) at
   the tile pairs of the first full-resolution pass of the 640×480 pair,
   with the pair list's live chunks per query tile (min, median, max) and
   the previous design's time, then the same clouds in 2-D (x, y), then the
   masked kernel at the first pass of phase 7 (0.5 m gate: more survivors
   than the budget); the compact wrapper with a budget one short of the
   survivors (its masked fallback); the three launches under
   ``torch.cuda.set_sync_debug_mode("error")``; each case timed as in phase
   2 beside its arithmetic bound (D + 2 products, D + 1 sums and a compare
   per visited pair of D-dimensional points, at 67 TFLOP/s; the compact
   and masked kernels' plain versions timed once after a warm-up run) with
   the kernel's launch
   parameters and, for the fused kernel, ``torch.cdist`` + ``min`` as a
   two-call yardstick;
6. rigid ICP, the second main path: ``icp_multires`` registers frame 1 of
   the sequence onto frame 0 (307,200 points each) with the JAX bench's
   settings; launches per level (the compact kernel must run on both),
   iterations, ms by the host clock after a warm-up run, the error against
   the true relative pose beside that pose's size (< 5e-4 m and < 1e-4 rad,
   well inside the 5 mm and 4e-4 rad the frames are apart) and a profiler
   window;
7. ``icp`` with the ``entry()`` settings (a 0.5 m gate) on the same pair:
   more tile pairs survive than the budget holds, so the masked kernel runs;
8. ``entry()`` on the card: the fused kernel must run, the toy pair's
   transform must come out within 5e-3 m and 5e-3 rad of the one that made
   it (0.027 m and 0.05 rad; the 10 iterations stop short of convergence),
   and its ``ICPResult.iterations`` must lie on the card;
9. ``icp_multires`` on a 160×120 pair on the card and on the CPU (the plain
   versions, pruned as on the card), agreeing within 1e-4 m / 1e-4 rad;
10. the pool pipeline, the third main path: ``run_fusion_sequence`` on the
    same 16 frames with the JAX bench's settings (pool of 430,080 rows,
    stride-2 localize). The gather kernel must launch 2 × 15 + Σ ICP
    iterations times (integrate's model-row gather and inverse-gather
    update per frame, one per ICP iteration); ATE < 2e-4 m and more than
    0.9·H·W finite live points. A repeat gives the host clock's spread; the
    same run with the gather replaced by its plain version must launch
    nothing and give the same poses and pool bit for bit;
11. the gather kernel against its plain version, bit for bit, on the first
    stream of each call site of phase 10, a random stream and one with 30%
    wildcards at the integrate shape, timed as in phase 2 beside
    ``torch.index_select`` and two byte bounds at 3.35 TB/s: indices and
    output rows once, and each distinct source row once (``bound_ms``) or
    each distinct 64-byte segment of the source the indices touch
    (``bound_64b_ms``; every gather held on a path reports both);
12. a per-stage time split of the pool frame and a profiler window
    (informational);
13. the first 4 frames of the pool pipeline on the CPU (the plain
    versions), agreeing with the card within 1e-4 m / 1e-4 rad;
14. kNN normals, the fourth main path: ``PointCloud.with_normals_knn(k=12)``
    on frame 0 back-projected by ``depth_to_points`` (307,200 rows, invalid
    pixels masked). The compact kNN kernel must launch; the radius-doubling
    rounds, the surviving and visited tile pairs, host ms after a warm-up
    (and the median of 5 more runs),
    a profiler window and the median |cos| to the depth image's normals
    (> 0.9); then (informational) the normals' Jacobi eigensolver on every
    neighbourhood beside cuSOLVER's ``torch.linalg.eigh``;
15. frame 1 onto frame 0 with ``icp_multires`` and the bench levels, the
    destination normals from ``with_normals_knn``: phase 6's bounds (host
    ms of the counted run and the median of 3 more);
16. ``with_normals_knn(k=12)`` on frame 0 grid-downsampled below 8,192
    points (Q·M < 2²⁶): the full kNN kernel must launch, the compact one
    not;
17. the JAX bench's neighbour rows on the frame's valid points
    (informational): ``knn(q, q, 10, exclude_self=True)``,
    ``radius_search_pruned(q, q, 0.01, 10, exclude_self=True)`` and
    ``with_normals_radius(0.01, max_neighbors=16)``, which must take the
    compact kernel, and ``with_normals_radius(0.01)`` at its default cap
    of 32, which must take the grid search (no kernel); host ms, peak
    device memory and the profiler's device kernel ms;
18. each kNN kernel against its plain version, bit for bit, timed as in
    phase 2 beside its arithmetic bound (10 operations per visited pair):
    the compact kernel at phase 14's first-round pair list (k = 12, with
    and without the diagonal, then k = 1, the distance cost alone, and
    k = 65; the whole wrapper, which builds its work on the card with no
    host sync (checked), timed beside that work and the launch alone; its
    plain version syncs, so it is timed on the host clock), the
    compact wrapper's full-kernel fallback on 16 query tiles, the full
    kernel at phase 16's shape and at 4096² random points with k = 1, 12
    and 65, beside ``torch.cdist`` + ``topk``; each case with the kernel's
    launch parameters (key splits, queries a thread, where the slots live)
    and the kernel time the previous design took on the same case;
19. ``with_normals_knn(k=12)`` on a 160×120 frame on the card (pruned
    kernel path) and on the CPU (the tiled scan): |cos| ≥ 0.999 on at
    least 99% of the points valid in both;
20. ``scale2``, the wide-row probe's copy kernel, once on the (CAP/8, 128)
    pool view, bit for bit against ``2.0 * x``, beside ``torch.mul`` (five
    alternating pairs, the medians) and its byte bound;
21. ``run_splat_sequence_scanned`` on phase 3's frames: one graph-form
    step run under ``torch.cuda.set_sync_debug_mode("error")``, then the
    host loop and the CUDA-graph replay in two alternating pairs (loop,
    graph, graph, loop; host ms a frame, the graph's best of 3); the
    graph's device ms a frame (CUDA events), the same with one GN
    iteration (so the cost of an iteration and of the masked ones) and its
    profile beside phase 3's busy time; launches a replay (6 window reads
    and rotations, one election and one row rebuild); the GN iterations
    kept and masked; ATE < 2e-3 m and poses within 1e-5 of phase 3's, bit
    identity reported;
22. ``run_fusion_sequence_scanned`` on phase 10's inputs, measured as
    phase 21: ATE < 2e-4 m, poses within 1e-4 of phase 10's, and the
    gather kernel launched 2 + 6 times a replay, (2 + 6) × 15 a run.
23. the non-rigid warp at the JAX bench's width (bench.py:130-186,
    862-887, with a synthetic source: ``tests/test_warp_field.py``'s
    height-field surface at 120,000 points scaled to a 0.72 m patch, the
    bench's bend as target): the 2.5 cm control grid (1,040 nodes,
    capacity 1,056), ``build_deformation_graph`` (k = 4 anchors, 8 arcs)
    and ``icp_warp_field`` with the bench's settings, which takes the
    sorted direct route; graph and solve ms (host, best of 3 after a
    warm-up, and CUDA events), outer iterations, the warped cloud's error
    (median and 95th percentile, and its parts along and across the
    patch: the bound is a normal error under a quarter of the normal
    displacement, as the bend's y term slides points along the patch
    where nearest-point correspondences cannot see it), launches, a stage
    split (nn search, assembly, Cholesky, increment) that must reproduce
    the solve bit for bit, a profiler window, one direct GN step under
    ``torch.cuda.set_sync_debug_mode("error")``, two solves with the same
    bits, and each kernel the graph build and the solve launched bit for
    bit against its plain version on the inputs of its last call, timed
    beside its bound;
24. ``icp_warp_field_batched`` with the bench's 8 targets on that graph:
    ms a solve amortised, outer iterations, each stream's error (the same
    bound) and its warped points within 1e-4 m (median) and 1e-3 m (max)
    of a single direct solve of the stream with the batch's outer
    iterations; one batched GN step with no host sync; a profiler window;
25. the other routes at 20,000 of the points and the same grid, card
    against the port's CPU run within the same bounds and with the same
    outer iterations, CG iteration counts reported: ``solver="cg"``
    (block-Jacobi), ``build_dense_graph`` with CG (one outer iteration:
    the dense system is ill-conditioned, see :func:`warp_other_routes`)
    and ``icp_warp_field_projective`` on a 160×120 depth frame of the
    patch (the gather kernel once an outer iteration).

26. ``run_slam`` at the JAX bench's SLAM row (bench.py:1035-1083): 48
    frames of ``synthetic_panorama_sequence(seed=3, depth_noise=0.008)``
    at 320×240, ``map_capacity = 8·H·W``, ``FusionConfig(localize_stride=1,
    icp_iterations=8)``, ``SlamConfig(keyframe_every=5,
    loop_min_separation=3, loop_edge_weight=5.0)``, the scanned front end,
    once with ``run_ba=False`` and once with ``run_ba=True``: keyframes,
    loop closures, max and endpoint orientation error and ATE before and
    after the backend, map points, host ms of each stage (front end,
    keyframes, loop closures, pose graph, BA, rebuild; a second run, each
    stage ended by a synchronise), the launches of each stage and a profile
    window (of the run with BA, which runs every stage). It fails unless a
    loop closes, the front end drifts by more than 1°, the max and
    endpoint orientation errors fall below 0.65 of the front end's, the map
    holds more than H·W points and more than 95% of them lie within 0.7 m
    of the 2.5 m wall, and the ATE after the backend is at most 1.2 times
    the front end's (``tests/test_slam_loop.py``'s bounds). At this shape
    the JAX package's own BA run breaks that ATE bound (3.6457 → 4.5527 cm,
    a ratio of 1.2488, ``tests/torch_slam_witness.py`` on the CPU), so the
    run with BA is held instead to within 0.03 of that ratio, the run
    without BA (JAX: 1.0660) to the bound; each kernel the path launched
    is held bit for bit against its plain version on the inputs of its
    last call and timed beside its bound;
27. ``bundle_adjust`` at mapping scale (``tests/test_slam_backend.py:133``:
    K = 64, L = 100,000, O = 300,000, seed 0, 3 outer iterations, 30 CG
    iterations): ``torch.linalg.inv_ex`` on 100,000 3×3 and 64 6×6 SPD
    matrices (status, residual, no host sync), the residual before and
    after (it must fall), host and CUDA-event ms, outer and CG iteration
    counts, both PCG forms (all iterations masked with no host read, and
    ``cilantro_tpu_torch/tools/pcg_forms.py``'s host read an iteration;
    the same bits, at max_cg 30 and 60), two
    solves with the same bits, one step under
    ``torch.cuda.set_sync_debug_mode("error")``, a profile window; then
    ``optimize_pose_graph`` and ``bundle_adjust`` card against CPU on
    small problems within 1e-4;
28. ``run_batched_fusion_sequences`` at the JAX bench's multi-stream row
    (bench.py:440-478, uncut): B = 8 streams of 12 synthetic 640×480
    frames (seeds 100-107), pools of 430,080 rows, stride-2 localize, one
    captured B-stream step replayed a frame. It fails unless every
    stream's ATE is below 2e-4 m (the pool bound), each stream's poses lie
    within 1e-4 of ``run_fusion_sequence_scanned`` on that stream alone
    (one pass), a replay launches the gather and the rotation kernel as
    often at B = 8 as at B = 1 and as the single-stream replay, the same
    steps run eagerly give the replay's poses and pools bit for bit, and
    each gather site (model rows, inverse-gather update, ICP targets) and
    the rotation kernel on the inputs of their last call agree with their
    plain versions bit for bit (timed as the warp's kernels, beside the
    byte bound and ``torch.index_select``); aggregate frames/s, host and
    device ms a step (and at B = 1) and a profile window's idle share;
29. ``run_fusion_sequence_pipelined`` (front end on a side CUDA stream,
    tracker on the step's stream) on phase 22's frames and configuration:
    poses, ICP iterations and pool bit for bit those of
    ``run_fusion_sequence_scanned``; host and device ms a frame of both in
    alternating turns.
30. the JAX bench's estimation row (bench.py:220-252, 676-757, uncut) on
    phase 23's 120,000-point height field, the stand-in for the bench's
    ``p1``: ``ransac_plane`` with 1,024 hypotheses and a 1 cm gate, then on
    a planted case (120,000 points, 60% on a known plane with 3 mm of
    noise, 40% uniform in a 2 m cube; it fails unless the normal is within
    0.5°, the offset within 5 mm and ≥ 95% of the planted inliers are
    kept); ``ransac_transform`` on bench.py:228-242's 20,000
    correspondences (0.2 rad about z, 30% outliers; 1,024 hypotheses, a
    2 cm gate; < 1e-4 rad and < 1e-4 m, the rotation kernel launched);
    ``kmeans(k=16)`` with its iterations, the bench's roofline figures and
    its centroid update as the one-hot GEMM beside a broadcast sum;
    ``fit_pca`` (eigenvalues within 1e-4 of float64 numpy, det = +1).
    Each with host ms (best of 3 after a warm-up, ended by a synchronise),
    the median ms between CUDA events around a run (wall time: the
    estimators read back) and a profile (informational);
31. the clustering path on the same cloud: ``knn_search(k=8)`` →
    ``edge_mask_from_evaluator(max_distance=0.02)`` →
    ``connected_components(min_size=100)`` (the compact kNN kernel must
    run), capped ``mean_shift`` (2 cm, ``max_neighbors=16``: the compact
    kNN kernel must run), ``spectral_clustering_knn`` on three planted
    blobs of 10,000 points (k = 12, ``filter_degree=16``; the labels must
    recover the blobs exactly, up to renaming) and
    ``find_nn_correspondences_bidirectional`` on phase 6's pair (frames
    1 → 0), ungated (the fused nn1 kernel) and with a 2 cm gate (the
    pruned route); an nn1 kernel must run in each. Each with launches,
    host and CUDA-event wall ms and a profile's idle share;
32. the same entry points at 8,000 points and 128 hypotheses on the card
    and on the CPU (plain versions), on draws made once on the card: the
    best hypothesis and inlier counts within 0.1% of N, k-means with the
    same iterations, centroids within 1e-4 and ≥ 99.9% of labels equal,
    components with the same count and ≥ 99.9% of labels equal after
    renaming, PCA within 1e-5;
33. PLY files: the host C++ (``cilantro_tpu_torch/csrc/host/``) built
    with ``g++`` (a failed build raises); frames 0 and 1 (compacted,
    colours the ``jet`` colormap of the depth) written by ``to_ply`` in
    binary and ASCII under a temporary directory and read back by the C++
    codec (called directly) and the Python parser: points and normals bit
    for bit, the 8-bit colours equal; the binary pair loaded onto the card
    by ``PointCloud.from_ply`` and registered as phase 15 does (frame 1
    onto frame 0): normals, pose and iterations bit for bit those of the
    in-memory pair, within phase 6's bounds; each kernel of that run
    (compact kNN, compact nn1, rotation) held bit for bit on its last
    call; host ms (median of 3) of a write and a read of each format by
    each reader, and the file sizes;
34. the pool host loop on 6 frames with a ``LiveMapViewer(every=2)``
    hook: each snapshot's scene holds the map's valid points, subsampled
    as ``live.py`` does, bit for bit; the gather and the rotation kernel
    held bit for bit on their last calls there; ``render_cloud_image`` of
    the final map on the card against ``device="cpu"`` (the background
    the same, the share of pixels whose colours differ by more than 1e-6);
    ``op_time`` of the integrate-stream gather, eager (linearity > 1.3)
    and over CUDA-graph replays of its two loops, beside the CUDA-event
    median, and its ``roofline`` line (on standard error); the snapshots'
    host ms.

35. the multi-device paths at world size 1 over NCCL on the card
    (``make_mesh()`` with no process group makes a world of one), each
    against its one-device counterpart and each kernel it launched held
    bit for bit on its last call at each input shape (the fused nn1
    kernel's plain version at 307,200² timed on the compared run only):
    ``sharded_combined_icp`` and ``sharded_combined_icp_ring`` on phase 6's
    pair (phase 6's bounds against the true motion; a fused nn1 and a
    rotation launch an iteration), ``sharded_fusion_step`` over 6 frames
    with a pool of 4·H·W = 1,228,800 slots and stride-2 localize (poses
    within 5e-5 of ``fusion_step``'s, live rows within 0.1%; host and
    CUDA-event ms a frame of both, and of one frame's collectives alone),
    ``sharded_icp_warp_field`` on phase 23's height field with CG (bit
    for bit ``icp_warp_field``'s and a second sharded run's),
    ``bundle_adjust_sharded`` at phase 27's scale (residual below 3.0, two
    solves the same bits, within 1e-4 of ``bundle_adjust``) and
    ``run_slam`` with ``SlamConfig.ba_mesh`` at phase 26's row under its
    bounds;
36. ``PARALLEL_RANKS`` gloo ranks on the one card, as subprocesses of
    this script (``--rank``), on the same paths (not ``run_slam``, whose
    front end every rank would repeat) and the two-rank pipeline on
    phase 10's 16 frames: each rank's results within the CPU tests'
    tolerances of phase 35's (the ICPs within 1e-5 with the same
    iterations, the warp 1e-4 m median, the BA 1e-4; fusion on two map
    shards deals augments to other slots, so phase 35's bounds against
    the one-device step), the pipeline bit for bit the scanned driver,
    every replicated output the same on both ranks; host and CUDA-event
    ms of each. Then a ``{"parallel_paths": ...}`` line;
37. beside phase 11, the gather's designs in one A/B
    (``cilantro_tpu_torch/tools/gather_variants.py``, built with the
    kernels in phase 1): the first design, the kernel as built, its
    source variants and the other designs of
    ``tools/gather_alternatives.cu``, each held bit for bit against the
    plain gather and timed as in phase 2, forward then backward, on every
    stream that phases 11, 25, 26, 28, 34 and 35 held, and on rows at a
    stride of 1, 2 and 4 of the B = 8 ICP source (those and the B = 8 ICP
    stream also with the L2 cleared before each run); then a
    ``{"gather_designs": ...}`` line with each stream's time as built
    against the first design;
38. every example of ``cilantro_tpu_torch/examples/`` through its
    ``main([..., "--device", "cuda", "--out", tmp])`` at its default,
    full-width input (the 120,000-point height field, 640x480 frames, the
    SLAM demo's 48 frames of 96x128): the truth each one prints held to
    its bound (:func:`example_truth`: rigid ICP's max abs error < 1e-3,
    fusion's ATE < 1 mm, the SLAM loop closed and the drift cut, the
    splat ATE < 2 mm and each batched warp stream < 10 mm, the planted
    RANSAC transform, the blobs and rings' labels, the PLY round trip
    exact, ...), the host-code examples line for line their CPU run, host
    s, each kernel's launches (counts set to 0 just before each example)
    and each kernel's last call there bit for bit against its plain
    version, timed beside its bound; then an ``{"examples_paths": ...}``
    line;
39. ``dryrun_multichip``: (a) ``dryrun_multichip(1)`` at world size 1
    over NCCL (launches counted from 0, each kernel held bit for bit on
    its last call at each input shape), then each of its parts alone with
    host and CUDA-event ms; (b) two gloo ranks on the one card as
    subprocesses (``--dryrun-rank``), each part's ms on each rank and
    every replicated output the same bits on both; then a
    ``{"dryrun_paths": ...}`` line.

Before phase 23 one empty launch (``torch.cuda._sleep(0)``) is timed as in
phase 2, beside the gather's ICP-stream time and bound (informational).

Each kernel's launch count in the kernels line comes from the path that
runs it (counts set to 0 just before that path and read just after):
splat fusion for the splat kernels, phase 6 for the compact kernel, phase
7 for the masked one, phase 8 for the fused one, phase 10 for the gather,
phase 14 for the compact kNN kernel, phase 16 for the full one, phase 20
for ``scale2``, splat fusion for the rotation kernel (which replaces no
Pallas kernel: ``jnp.linalg.svd`` inside XLA). Phases 21-22 count a
replay's launches at capture, where the wrappers run. The ``warp_paths``
line before the kernels line gives each kernel's launches on phases 23-25,
the ``slam_paths`` line on phases 26-27 (by stage; the scanned front end's
wrappers run at its warm-up step and its capture, and the line gives its
launches a replay beside them), the ``batched_paths`` line on phases
28-29 (launches a replay, and those counted over the run), the
``g2_paths`` line on phases 33-34, the ``parallel_paths`` line on
phases 35-36 (and each kernels-line entry of rows 4, 5, 7 and the
rotation kernel its ``sharded_launches`` on each phase 35 path), the
``estimation_paths`` line on phases 30-32 (by path; each kernel of phases
30-31 held bit for bit against its plain version on the inputs of its
last call on each path at each input shape and ``k``, and timed beside
its bound: the rotation kernel on ``ransac_transform``'s 1,024 minimal
fits and on its re-estimate, the compact kNN kernel on the components
chain and on mean shift), the ``examples_paths`` line on phase 38 (by
example; a scanned driver's wrappers run at its warm-up step and its
capture, as in phases 21-22) and the ``dryrun_paths`` line on phase 39
(and each kernels-line entry its ``sharded_launches`` on phase 39a).

Every line of standard output before the last two is one JSON object. The
line before the last is the card's name and power limit as ``nvidia-smi``
gives them; the last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_OPS_PER_S = 67e12  # H100 SXM float32 rate off the tensor cores
BENCH_LEVELS = ((0.02, 10, 32768, 0.0064), (None, 3, None, 0.01))  # bench.py:194
RADIUS, MARGIN, LAYERS = 4, 16, 2
H, W = 480, 640
HM, WM = H + 2 * MARGIN, W + 2 * MARGIN  # the model grid: 512 x 672
FRAMES, CPU_FRAMES = 16, 4
REPS = 25
POOL_CAPACITY = 430_080  # int(1.4 · H · W), the JAX bench's pool (bench.py:374-377)


def emit(**record):
    print(json.dumps(record), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def device_ms(fn) -> float:
    """Median device time of ``fn`` over ``REPS`` runs, in ms. Each run is
    queued behind a sleep kernel longer than the host takes to enqueue it,
    so the events bracket device work only."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    cycles = int(max(2e6, 4 * host_s * 2e9))
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| (0 where the two are equal, infinities included)."""
    a64, b64 = a.double(), b.double()
    return float(torch.where(a64 == b64, 0.0, (a64 - b64).abs()).max())


def assert_same_bits(name, kernel_out, plain_out):
    for k, p in zip(kernel_out, plain_out):
        kb, pb = k.contiguous().view(torch.int32), p.contiguous().view(torch.int32)
        if not torch.equal(kb, pb):
            bad = int((kb != pb).sum())
            raise AssertionError(f"{name}: kernel and plain version differ at {bad} elements")


def phase2_inputs(dev):
    """Phase 2's inputs of the three splat kernels at the model grid, drawn
    from one generator in this order: a 7-channel frame broadcast to both
    layers and window codes; argmin2's tie-heavy keys and codes; an
    8-channel map broadcast to the winner and runner-up codes. Codes are
    uniform with ~20% -1; on a (2R+1)-window grid the codes near the border
    reach into the pad."""
    rng = np.random.default_rng(0)
    r = RADIUS
    w2 = 2 * r + 1
    hp, wp = HM + 2 * r, WM + 2 * r

    def codes(shape, high):
        c = rng.integers(0, high, size=shape).astype(np.int32)
        c[rng.random(shape) < 0.2] = -1
        return torch.from_numpy(c).to(dev)

    img = torch.from_numpy(
        rng.integers(-(2**31), 2**31 - 1, size=(1, 7, hp, wp), dtype=np.int64).astype(np.int32)
    ).to(dev).expand(LAYERS, -1, -1, -1)
    off = codes((LAYERS, HM, WM), w2 * w2)
    key, aoff = argmin2_tie_case(rng, dev)
    rows = torch.from_numpy(
        rng.standard_normal((1, LAYERS, 8, hp, wp)).astype(np.float32)
    ).to(dev).expand(2, -1, -1, -1, -1)
    code = codes((2, HM, WM), LAYERS * w2 * w2)
    return {"window_read_codes": (img, off), "splat_argmin2": (key, aoff),
            "flow_select_rows": (rows, code)}


def kernel_checks(splat, dev):
    """Phase 2: each kernel against its plain version at main-path shapes."""
    r = RADIUS
    inputs = phase2_inputs(dev)
    img, off = inputs["window_read_codes"]
    key, aoff = inputs["splat_argmin2"]
    rows, code = inputs["flow_select_rows"]
    records = [
        dict(name="window_read_codes", replaces="cilantro_tpu/slam/splat.py:312",
             kernel=lambda: splat.window_read_codes(img, off, radius=r),
             plain=lambda: splat.window_read_codes_plain(img, off, r),
             nbytes=window_read_bytes(img, off, r)),
        dict(name="splat_argmin2", replaces="cilantro_tpu/slam/splat.py:107",
             kernel=lambda: splat.splat_argmin2(key, aoff, radius=r),
             plain=lambda: splat.splat_argmin2_plain(key, aoff, r),
             nbytes=argmin2_bytes(aoff), case="tie-heavy random"),
        dict(name="flow_select_rows", replaces="cilantro_tpu/slam/splat.py:221",
             kernel=lambda: splat.flow_select_rows(rows, code, radius=r),
             plain=lambda: splat.flow_select_rows_plain(rows, code, r),
             nbytes=select_rows_bytes(rows, code, r), case="random codes"),
    ]

    out = []
    for rec in records:
        as_tuple = lambda x: x if isinstance(x, tuple) else (x,)  # noqa: E731
        k_out, p_out = as_tuple(rec["kernel"]()), as_tuple(rec["plain"]())
        torch.cuda.synchronize()
        assert_same_bits(rec["name"], k_out, p_out)
        err = max(max_abs_err(k, p) for k, p in zip(k_out, p_out))
        ms = device_ms(rec["kernel"])
        plain_ms = device_ms(rec["plain"])
        bound_ms = rec["nbytes"] / HBM_BYTES_PER_S * 1e3
        entry = dict(
            name=rec["name"], route="cuda", source="cilantro_tpu_torch/csrc/splat_kernels.cu",
            replaces=rec["replaces"], max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by="bytes", library_ms=None,
            bytes=rec["nbytes"],
        )
        extra = {}
        if "case" in rec:
            extra = dict(case=rec["case"], design=dict(splat.kernel_design[rec["name"]]),
                         previous_design_ms=PREVIOUS_SPLAT_MS[(rec["name"], rec["case"])])
        emit(phase="kernel_vs_plain", tolerance="bit-exact", **entry, **extra)
        out.append(entry)
    return out


# Kernel ms of the previous designs, NVIDIA H100 80GB HBM3 at 700 W:
# splat_argmin2 (one thread per target, a dependent check of each of its
# 162 candidate sources), this script's phase 2 case (CUDA events) and the
# path's frames (the profile phase's mean over 6 frames);
# flow_select_rows (one thread a pixel, four divisions, scalar stores),
# tools/select_rows_variants.py: the mean of its two visits of each case.
PREVIOUS_SPLAT_MS = {
    ("splat_argmin2", "tie-heavy random"): 0.05951999872922897,
    ("splat_argmin2", "splat path frame"): 0.048864666666666993,
    ("flow_select_rows", "random codes"): (0.037087999284267426 + 0.036959998309612274) / 2,
    ("flow_select_rows", "splat path frame"): (0.0161920003592968 + 0.0163199994713068) / 2,
}


def argmin2_tie_case(rng, dev):
    """Padded keys and offset codes of one stream, two layers at the model
    grid: keys in [0.5, 3) m with 10% at 1.0 (ties), codes uniform in the
    window with ~20% -1 (keys +inf there)."""
    r = RADIUS
    w2 = 2 * r + 1
    shape = (1, LAYERS, HM + 2 * r, WM + 2 * r)
    key = torch.from_numpy((0.5 + 2.5 * rng.random(shape)).astype(np.float32))
    key[torch.from_numpy(rng.random(shape) < 0.1)] = 1.0
    c = rng.integers(0, w2 * w2, size=shape).astype(np.int32)
    c[rng.random(shape) < 0.2] = -1
    aoff = torch.from_numpy(c).to(dev)
    return torch.where(aoff >= 0, key.to(dev), float("inf")), aoff


def argmin2_bytes(off) -> int:
    """splat_argmin2's bytes: every code read once, the keys of the sources
    with a code in the window once, the four (B, H, W) outputs written once."""
    r = RADIUS
    b, _, hp, wp = off.shape
    n_ok = int(((off >= 0) & (off < (2 * r + 1) ** 2)).sum())
    return off.numel() * 4 + n_ok * 4 + 4 * b * (hp - 2 * r) * (wp - 2 * r) * 4


def _distinct_elements(t) -> int:
    """Elements of a tensor whose batch entries may be one broadcast entry."""
    return t[0].numel() if t.shape[0] > 1 and t.stride(0) == 0 else t.numel()


def window_read_bytes(img, off, r) -> int:
    """window_read_codes' bytes: every code read once, the (B, C, H, W)
    output written once, and C words a code in the window, at most every
    distinct image word once."""
    b, c, hp, wp = img.shape
    n_ok = int(((off >= 0) & (off < (2 * r + 1) ** 2)).sum())
    return (off.numel() + b * c * (hp - 2 * r) * (wp - 2 * r)
            + min(_distinct_elements(img), n_ok * c)) * 4


def select_rows_bytes(rows, code, r) -> int:
    """flow_select_rows' bytes: every code read once, the (B, C, H, W)
    output written once, and C words a code in range, at most every
    distinct row word once."""
    b, layers, c, hp, wp = rows.shape
    n_ok = int(((code >= 0) & (code < layers * (2 * r + 1) ** 2)).sum())
    return (code.numel() + b * c * (hp - 2 * r) * (wp - 2 * r)
            + min(_distinct_elements(rows), n_ok * c)) * 4


PATH_KERNELS = ("window_read_codes", "splat_argmin2", "flow_select_rows")


@contextlib.contextmanager
def path_recorded(sf, kept: dict):
    """A context in which splat fusion's calls of the three splat kernels
    keep the last call's inputs in ``kept[name]`` as ``(args, radius)``
    (the tensors are made anew each frame or iteration and never written
    after the call)."""
    from unittest import mock

    def recorder(name):
        real = getattr(sf, name)

        def recording(*args, radius):
            kept[name] = (args, radius)
            return real(*args, radius=radius)

        return recording

    with contextlib.ExitStack() as stack:
        for name in PATH_KERNELS:
            stack.enter_context(mock.patch.object(sf, name, recorder(name)))
        yield


def code_coherence(code, width) -> float:
    """Share of aligned runs of ``width`` horizontally adjacent codes (in
    range or not) that are all equal: 1 where a bounded flow moves whole
    patches by one offset, about 0 for random codes."""
    c = code[..., : code.shape[-1] // width * width].reshape(*code.shape[:-1], -1, width)
    return float((c == c[..., :1]).all(-1).float().mean())


def path_frame_checks(splat, kept, case="splat path frame"):
    """Phase 3b: each splat kernel against its plain version, bit for bit,
    on the inputs of its last call on the main path, timed as in phase 2
    beside its byte bound (phase 2's formulas). Returns each kernel's
    ``{ms, plain_ms, bound_ms, max_abs_err}`` by name."""
    out = {}
    for name in PATH_KERNELS:
        args, r = kept[name]
        kernel = lambda: getattr(splat, name)(*args, radius=r)  # noqa: E731
        plain = lambda: getattr(splat, f"{name}_plain")(*args, r)  # noqa: E731
        as_tuple = lambda x: x if isinstance(x, tuple) else (x,)  # noqa: E731
        k_out, p_out = as_tuple(kernel()), as_tuple(plain())
        torch.cuda.synchronize()
        assert_same_bits(f"{name} on a path frame", k_out, p_out)
        if name == "window_read_codes":
            nbytes = window_read_bytes(*args, r)
            stats = dict(codes_in_window=int(((args[1] >= 0) & (args[1] < (2 * r + 1) ** 2)).sum()),
                         code_coherence_4=code_coherence(args[1], 4))
        elif name == "splat_argmin2":
            off = args[1]
            nbytes = argmin2_bytes(off)
            stats = dict(sources_in_window=int(((off >= 0) & (off < (2 * r + 1) ** 2)).sum()),
                         targets_with_a_runner_up=int((p_out[3] >= 0).sum()))
        else:
            rows, code = args
            nbytes = select_rows_bytes(rows, code, r)
            n_codes = rows.shape[1] * (2 * r + 1) ** 2
            stats = dict(codes_in_range=[int(((c >= 0) & (c < n_codes)).sum()) for c in code],
                         code_coherence_4=code_coherence(code, 4),
                         distinct_codes=int(torch.unique(code).numel()), shape=list(rows.shape))
        if name in splat.kernel_design:
            stats["design"] = dict(splat.kernel_design[name])
            if (name, case) in PREVIOUS_SPLAT_MS:
                stats["previous_design_ms"] = PREVIOUS_SPLAT_MS[(name, case)]
        entry = dict(max_abs_err=max(max_abs_err(a, b) for a, b in zip(k_out, p_out)), ms=device_ms(kernel),
                     plain_ms=device_ms(plain), bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
        emit(phase="kernel_vs_plain", tolerance="bit-exact", name=name, case=case, **entry, bytes=nbytes, **stats)
        out[name] = entry
    return out


def rot_angle(a: np.ndarray, b: np.ndarray) -> float:
    """Angle (rad) between two rotations, from the skew part of a·bᵀ
    (well conditioned near 0, unlike the trace)."""
    d = a.astype(np.float64) @ b.astype(np.float64).T
    s = 0.5 * np.array([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0], d[1, 0] - d[0, 1]])
    return float(np.arcsin(min(1.0, np.linalg.norm(s))))


def stage_split(sf, depths, k, cfg, dev, frames=6):
    """Per-stage host time of one frame (frame prep, localize, integrate),
    each stage ended with a synchronise: the layers' share of a frame."""
    d = [torch.as_tensor(x, device=dev) for x in depths[: frames + 1]]
    f0 = sf._frame_images(d[0], k, H, W)
    smap = sf.init_splat_map(*f0, cfg)
    pose = sf.identity(3, device=dev)
    split = {"frame_prep": [], "localize": [], "integrate": []}
    for depth in d[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = sf._frame_images(depth, k, H, W)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pose = sf.splat_localize(smap, *f, pose, k, cfg=cfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        smap = sf.splat_integrate(smap, *f, pose, k, cfg=cfg)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for name, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
            split[name].append(dt * 1e3)
    # The first frame initialises cuBLAS/cuSOLVER: report the median of the rest.
    return {name: statistics.median(v[1:]) for name, v in split.items()}


def profile_once(run, ms_unprofiled, runs=1):
    """Device kernel time of ``run`` (torch.profiler), which does ``runs``
    units of work (frames, registrations), per unit and beside the
    unprofiled host time of one: the device's busy and idle share.
    Informational: a profiler that sees no device time reports "not
    measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(
        ((evt.self_device_time_total, evt.key, evt.count) for evt in prof.key_averages()
         if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0),
        reverse=True,
    )
    busy_ms = sum(r[0] for r in rows) / 1e3 / runs
    if busy_ms == 0:
        return {"device_busy": "not measured"}
    return {
        "runs": runs,
        "device_kernel_ms": busy_ms,
        "kernel_launches": sum(r[2] for r in rows) / runs,
        "wall_ms_under_profiler": wall_ms / runs,
        "ms_unprofiled": ms_unprofiled,
        "device_idle_share": 1.0 - busy_ms / ms_unprofiled,
        "top_kernels": [
            {"kernel": key[:90], "ms": us / 1e3 / runs, "launches": c / runs}
            for us, key, c in rows[:12]
        ],
    }


def profile_window(sf, depths, k, cfg, dev, ms_per_frame, frames=6):
    """:func:`profile_once` over ``frames`` steady frames of splat fusion,
    per frame."""
    d = [torch.as_tensor(x, device=dev) for x in depths[: frames + 2]]
    smap = sf.init_splat_map(*sf._frame_images(d[0], k, H, W), cfg)
    smap, pose = sf.splat_fusion_step(smap, d[1], sf.identity(3, device=dev), k, cfg=cfg)
    state = {"smap": smap, "pose": pose}

    def run():
        for depth in d[2:]:
            state["smap"], state["pose"] = sf.splat_fusion_step(
                state["smap"], depth, state["pose"], k, cfg=cfg
            )

    return profile_once(run, ms_per_frame, runs=len(d) - 2)


# ---------------------------------------------------------------------------
# Rigid ICP and its nn1 kernels.
# ---------------------------------------------------------------------------


def nn1_bound(pairs: int, nbytes: int, dim: int = 3):
    """Least time for ``pairs`` visited (query, key) pairs of ``dim``-D
    points: the larger of the arithmetic and the bytes (inputs read once,
    outputs written once). The function needs dim + 2 products, dim + 1
    sums and a compare per pair; the published float32 rate counts an FMA
    as two operations, so this is the time of a kernel that fuses every
    product into a sum (the port's kernels issue no FMA)."""
    ops_ms = pairs * (2 * dim + 4) / F32_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def frame_clouds(depth, k, dev):
    from cilantro_tpu_torch.core.rgbd import depth_to_points_normals

    return depth_to_points_normals(torch.as_tensor(depth, device=dev), k)


def coarse_clouds(src, dst, level):
    """The clouds ``icp_multires`` registers at a downsampled level."""
    from cilantro_tpu_torch.core.containers import PointCloud
    from cilantro_tpu_torch.core.grid import grid_downsample

    bin_size, _, capacity, _ = level
    (sp, _, sv), (dp, dn, dv) = src, dst
    sc = grid_downsample(PointCloud(points=sp, valid=sv), bin_size, capacity=capacity)
    dc = grid_downsample(PointCloud(points=dp, normals=dn, valid=dv), bin_size, capacity=capacity)
    return (sc.points, None, sc.valid), (dc.points, dc.normals, dc.valid)


def first_pass(nn, src, dst, mcd):
    """The augmented operands and tile pairs of the first nn1 pass of
    ``icp`` (identity start) on ``src`` → ``dst``; 2-D clouds, which
    ``icp`` does not prune, get the plan ``nn1_pruned`` would make."""
    (sp, _, sv), (dp, _, dv) = src, dst
    if sp.shape[1] == 2:
        plan = nn.make_nn1_prune_plan(dp, mcd ** 0.5, sp, key_valid=dv, query_valid=sv)
    else:
        plan = nn.maybe_make_nn1_prune_plan(dp, mcd, sp, key_valid=dv, query_valid=sv)
    if plan is None:
        raise AssertionError("the first pass of the main path is not pruned")
    qs, within, budget = nn.prune_mask(sp, plan)
    qp = nn._augment_queries(qs, plan.tile_q)
    return qp, plan.kp, within, budget, plan.tile_q, plan.tile_m


# Kernel ms of the previous nn1 kernels (one thread per query, 8 terms;
# the compact and masked ones with each block walking its query tile's
# whole run, the fused one with 128 queries a block over every key), NVIDIA
# H100 80GB HBM3 at 700 W: the compact and masked ones at phase 5's
# first-pass list (PERF.md §6 table), the fused one at its two cases (final
# run of PR 6).
PREVIOUS_NN1_MS = {
    ("nn1_compact", "first pass"): 7.406591892242432,
    ("nn1_masked", "first pass"): 7.277247905731201,
    ("nn1_fused", "4096x4096"): 0.164000004529953,
    ("nn1_fused", "32768x32768"): 1.4167360067367554,
}


def once_ms(fn, reps=1) -> float:
    """Median ms between CUDA events around ``reps`` runs of ``fn`` after a
    warm-up, for plain versions too slow to repeat 25 times: the device's
    time where ``fn`` keeps it busy, its wall time where ``fn`` reads back
    to the host."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nn1_kernel_checks(nn, pair, coarse, entry_inputs):
    """Phase 5: each nn1 kernel against its plain version, timed."""
    out = {}

    def record(name, shape, kernel, plain, pairs, nbytes, library=None, dim=3,
               plain_timer=device_ms, case=None, **extra):
        k_out, p_out = kernel(), plain()
        torch.cuda.synchronize()
        assert_same_bits(name, k_out, p_out)
        err = max(max_abs_err(a, b) for a, b in zip(k_out, p_out))
        bound_ms, bound_by = nn1_bound(pairs, nbytes, dim)
        entry = dict(
            name=name, route="cuda", source="cilantro_tpu_torch/csrc/nn1_kernels.cu",
            replaces=REPLACES[name], max_abs_err=err, ms=device_ms(kernel),
            plain_ms=plain_timer(plain), bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None if library is None else device_ms(library),
            pairs=pairs, bytes=nbytes,
        )
        if name in nn.kernel_design:
            extra.update(design=dict(nn.kernel_design[name]))
        if case is not None:
            extra.update(case=case, previous_design_ms=PREVIOUS_NN1_MS.get((name, case)))
        emit(phase="nn1_kernel_vs_plain", tolerance="bit-exact", shape=shape, **entry, **extra)
        return entry

    def split_cases(case, src, dst, mcd, dim, routes=("nn1_compact", "nn1_masked"), over_budget=False):
        """The compact and masked kernels at the first pass of ``icp`` with
        the gate ``mcd`` on ``src`` → ``dst`` (plain versions timed once:
        each takes hundreds of ms); returns their entries."""
        qp, kp, within, budget, tq, tm = first_pass(nn, src, dst, mcd)
        terms = nn._live_terms(dim)
        survivors = int(within.sum())
        runs = within.sum(dim=1).cpu().numpy()
        emit(phase="nn1_pair_list", case=case, dim=dim, survivors=survivors, budget=budget,
             over_budget=survivors > budget, query_tiles=int(within.shape[0]),
             key_chunks=int(within.shape[1]), live_chunks_per_query_tile=dict(
                 min=int(runs.min()), median=float(np.median(runs)), max=int(runs.max())))
        if over_budget and not survivors > budget:
            raise AssertionError(f"{case}: {survivors} survivors fit the budget of {budget}")
        pairs = survivors * tq * tm
        io_bytes = (qp.numel() + kp.numel()) * 4 + qp.shape[0] * 8
        shape = f"{qp.shape[0]}x{kp.shape[0]}, tiles {tq}x{tm}, {survivors} of {within.numel()} pairs, {dim}-D"
        mask = within.to(torch.int32)
        entries = {}
        if "nn1_compact" in routes:
            qt, kt, fl = nn._compact_list(within, budget)
            entries["nn1_compact"] = record(
                "nn1_compact", shape,
                lambda: nn.compact_rows(qp, kp, qt, kt, fl, tile_q=tq, tile_m=tm, terms=terms),
                lambda: nn.compact_rows_plain(qp, kp, qt, kt, fl, tq, tm),
                pairs, io_bytes + 3 * 4 * budget, dim=dim, plain_timer=once_ms, case=case,
                budget=budget, terms=terms,
            )
        entries["nn1_masked"] = record(
            "nn1_masked", shape,
            lambda: nn.masked_rows(qp, kp, mask, tile_q=tq, tile_m=tm, terms=terms),
            lambda: nn.masked_rows_plain(qp, kp, mask, tq, tm),
            pairs, io_bytes + mask.numel() * 4, dim=dim, plain_timer=once_ms, case=case,
            terms=terms,
        )
        return entries, (qp, kp, within, survivors, tq, tm, terms)

    # Fused: the entry pair (its main-path shape), then the coarse level's size.
    for label, (q, kk, kv) in (
        ("4096x4096", (entry_inputs[0], entry_inputs[1], None)),
        ("32768x32768", (coarse[0][0], coarse[1][0], coarse[1][2])),
    ):
        # As nn1_fused pads and sums them.
        qp, kp = nn._augment(q, kk, kv, nn._fused_rows_multiple(q.shape[0]), 1)
        terms = nn._live_terms(q.shape[1])
        entry = record(
            "nn1_fused", label, lambda: nn.fused_rows(qp, kp, terms=terms),
            lambda: nn.fused_rows_plain(qp, kp),
            q.shape[0] * kk.shape[0], (qp.numel() + kp.numel()) * 4 + qp.shape[0] * 8,
            library=lambda: torch.cdist(q, kk).min(dim=1), case=label, terms=terms,
            library_is="torch.cdist + min over the same clouds (two calls, a yardstick; the port never calls it)",
        )
        out.setdefault("nn1_fused", entry)

    # Compact and masked: the first full-resolution pass of the main path
    # (the compact kernel's row), then the same clouds in 2-D.
    src, dst = pair
    first, (qp, kp, within, survivors, tq, tm, terms) = split_cases(
        "first pass", src, dst, BENCH_LEVELS[1][3], 3)
    out["nn1_compact"] = first["nn1_compact"]
    flat = [(c[0][:, :2].contiguous(),) + tuple(c[1:]) for c in (src, dst)]
    split_cases("first pass, x-y only", flat[0], flat[1], BENCH_LEVELS[1][3], 2)
    # The masked kernel at its own path's first pass: icp with the 0.5 m gate
    # overflows the budget (the masked kernel's row).
    wide, _ = split_cases("wide-gate first pass", src, dst, 0.25, 3, routes=("nn1_masked",),
                          over_budget=True)
    out["nn1_masked"] = wide["nn1_masked"]
    # The compact wrapper's fallback: a budget one short of the survivors.
    before = dict(nn.launch_counts)
    k_out = nn._nn1_compact(qp, kp, within, budget=survivors - 1, tile_q=tq, tile_m=tm, terms=terms)
    torch.cuda.synchronize()
    routed = {n: nn.launch_counts[n] - before[n] for n in before}
    if routed != {"nn1_fused": 0, "nn1_masked": 1, "nn1_compact": 0}:
        raise AssertionError(f"the over-budget compact call launched {routed}")
    assert_same_bits("nn1_compact fallback", [t.reshape(-1) for t in k_out],
                     nn.masked_rows_plain(qp, kp, within.to(torch.int32), tq, tm))
    emit(phase="nn1_compact_fallback", budget=survivors - 1, survivors=survivors,
         launches=routed, tolerance="bit-exact", max_abs_err=0.0)
    # No launch syncs with the host.
    qt, kt, fl = nn._compact_list(within, within.numel())
    mask = within.to(torch.int32)
    fq, fk = nn._augment(entry_inputs[0], entry_inputs[1], None,
                         nn._fused_rows_multiple(entry_inputs[0].shape[0]), 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        nn.compact_rows(qp, kp, qt, kt, fl, tile_q=tq, tile_m=tm, terms=terms)
        nn.masked_rows(qp, kp, mask, tile_q=tq, tile_m=tm, terms=terms)
        nn.fused_rows(fq, fk, terms=5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    emit(phase="nn1_no_sync", checked=["nn1_compact", "nn1_masked", "nn1_fused"])
    return out


def gt_error(linear, translation, rel):
    """Translation (m) and rotation (rad) error of an estimate against the
    true relative pose ``rel`` (4×4)."""
    dt = float(np.linalg.norm(translation.cpu().numpy() - rel[:3, 3]))
    return dt, rot_angle(linear.cpu().numpy(), rel[:3, :3])


def icp_main_path(nn, icp_mod, pair, rel, card):
    """Phase 6: ``icp_multires`` on the 640×480 pair with the bench's
    settings; returns the launches of the timed run. Each level is one
    ``icp`` call, so wrapping ``icp`` snapshots the counts per level."""
    from unittest import mock

    (sp, _, sv), (dp, dn, dv) = pair

    def run():
        return icp_mod.icp_multires(
            sp, dp, dst_normals=dn, src_valid=sv, dst_valid=dv, metric="combined",
            convergence_tol=1e-4, levels=BENCH_LEVELS,
        )

    run()  # warm-up: cuBLAS / cuSOLVER handles, allocator
    torch.cuda.synchronize()
    snaps, iterations = [], []
    level_icp = icp_mod.icp

    def counted_icp(*args, **kwargs):
        snaps.append(dict(nn.launch_counts))
        res = level_icp(*args, **kwargs)
        iterations.append(int(res.iterations))
        return res

    nn.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(icp_mod, "icp", counted_icp):
        res = run()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    snaps.append(dict(nn.launch_counts))
    per_level = [{k: b[k] - a[k] for k in a} for a, b in zip(snaps, snaps[1:])]
    launches = dict(nn.launch_counts)
    if any(lv["nn1_compact"] == 0 for lv in per_level):
        raise AssertionError(f"the compact kernel did not run on every level: {per_level}")
    dt, dr = gt_error(res.transform.linear, res.transform.translation, rel)
    true_t, true_r = gt_error(torch.eye(3), torch.zeros(3), rel)  # the motion itself
    if not (dt < 5e-4 and dr < 1e-4):
        raise AssertionError(
            f"relative pose off by {dt} m / {dr} rad; the frames are {true_t} m / {true_r} rad apart"
        )
    t0 = time.perf_counter()
    res2 = run()
    torch.cuda.synchronize()
    ms2 = (time.perf_counter() - t0) * 1e3
    repeat_diff = max(
        float((res.transform.linear - res2.transform.linear).abs().max()),
        float((res.transform.translation - res2.transform.translation).abs().max()),
    )
    if not repeat_diff < 1e-5:
        raise AssertionError(f"two runs of the ICP main path differ by {repeat_diff}")
    emit(
        phase="icp_main_path", pipeline="icp_multires", points=int(sp.shape[0]),
        levels=[list(lv) for lv in BENCH_LEVELS], launches=launches,
        launches_per_level=per_level,
        iterations_per_level=iterations,
        ms=ms, ms_repeat=ms2, repeat_max_diff=repeat_diff,
        translation_error_m=dt, rotation_error_rad=dr,
        true_translation_m=true_t, true_rotation_rad=true_r,
        correspondences_last=int(res.num_correspondences), card=card,
    )
    try:
        emit(phase="icp_profile", card=card, **profile_once(run, ms2))
    except Exception as e:  # informational phase: report and go on
        emit(phase="icp_profile", device_busy="not measured", error=f"{type(e).__name__}: {e}")
    return launches


def wide_gate_path(nn, icp_mod, pair, rel):
    """Phase 7: ``icp`` with the ``entry()`` settings (0.5 m gate) on the
    640×480 pair: the survivors overflow the budget, each pass is masked."""
    (sp, _, sv), (dp, dn, dv) = pair
    nn.reset_launch_counts()
    t0 = time.perf_counter()
    res = icp_mod.icp(
        sp, dp, dst_normals=dn, src_valid=sv, dst_valid=dv, metric="combined",
        point_weight=0.3, max_corr_dist_sq=0.25, max_iterations=3,
    )
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(nn.launch_counts)
    if launches["nn1_masked"] == 0:
        raise AssertionError(f"the wide-gate path did not run the masked kernel: {launches}")
    dt, dr = gt_error(res.transform.linear, res.transform.translation, rel)
    if not (np.isfinite(dt) and np.isfinite(dr)):
        raise AssertionError("the wide-gate registration is not finite")
    emit(phase="icp_wide_gate_path", max_corr_dist_sq=0.25, launches=launches,
         iterations=int(res.iterations), ms=ms, translation_error_m=dt, rotation_error_rad=dr)
    return launches


def rigid_fit(a: np.ndarray, b: np.ndarray):
    """``(R, t)`` with ``b ≈ a @ R.T + t`` for paired rows (Kabsch, float64)."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    ca, cb = a.mean(0), b.mean(0)
    u, _, vt = np.linalg.svd((b - cb).T @ (a - ca))
    r = u @ np.diag([1.0, 1.0, np.sign(np.linalg.det(u @ vt))]) @ vt
    return r, cb - r @ ca


def entry_path(nn):
    """Phase 8: the port's ``entry()`` forward on the card (the fused
    kernel). The toy pair was made by one rigid transform of paired points,
    recovered here exactly by a fit; the registration stops unconverged
    after its 10 iterations, so it is held to 5e-3, a tenth of the
    motion. Card against CPU is
    ``tests/test_torch_nn1_cuda.py``'s to check. The registration's
    ``ICPResult`` (kept through a wrapper of ``icp``) must lie on the card,
    ``iterations`` included."""
    from unittest import mock

    import cilantro_tpu_torch.entry as entry_mod

    fwd, args = entry_mod.entry()
    results = []
    level_icp = entry_mod.icp

    def kept_icp(*a, **kw):
        results.append(level_icp(*a, **kw))
        return results[-1]

    nn.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(entry_mod, "icp", kept_icp):
        lin, tr = fwd(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(nn.launch_counts)
    if launches["nn1_fused"] == 0:
        raise AssertionError(f"entry() did not run the fused kernel: {launches}")
    res = results[-1]
    if res.iterations.device != res.transform.linear.device or res.iterations.device.type != "cuda":
        raise AssertionError(
            f"entry()'s iterations lie on {res.iterations.device}, its transform on "
            f"{res.transform.linear.device}"
        )
    r, t = rigid_fit(args[0].cpu().numpy(), args[1].cpu().numpy())
    rel = np.eye(4)
    rel[:3, :3], rel[:3, 3] = r, t
    dt, dr = gt_error(lin, tr, rel)
    true_t, true_r = gt_error(torch.eye(3), torch.zeros(3), rel)
    if not (dt < 5e-3 and dr < 5e-3):
        raise AssertionError(
            f"entry() is off by {dt} m / {dr} rad; the pair is {true_t} m / {true_r} rad apart"
        )
    emit(phase="entry", launches=launches, ms=ms, iterations=int(res.iterations),
         iterations_device=str(res.iterations.device), translation_error_m=dt,
         rotation_error_rad=dr, true_translation_m=true_t, true_rotation_rad=true_r)
    return launches


def icp_card_vs_cpu(nn, icp_mod, k_small):
    """Phase 9: ``icp_multires`` on a 160×120 pair on the card and on the
    CPU; the CPU run is pruned as the card's is (the plain versions of the
    compact and masked kernels), by lifting ``prune_eligible``'s device
    test for that call."""
    from unittest import mock

    from cilantro_tpu_torch.slam.driver import synthetic_sequence

    depths, _ = synthetic_sequence(2, 120, 160, k_small, seed=0)
    eligible = nn.prune_eligible
    results = {}
    for dev in (torch.device("cuda"), torch.device("cpu")):
        (p0, n0, v0), (p1, _, v1) = (frame_clouds(d, k_small, dev) for d in depths)
        with mock.patch.object(
            nn, "prune_eligible",
            lambda q, k, m, metric="l2", device=None: eligible(q, k, m, metric, device="cuda"),
        ):
            nn.reset_launch_counts()
            res = icp_mod.icp_multires(
                p1, p0, dst_normals=n0, src_valid=v1, dst_valid=v0, metric="combined",
                convergence_tol=1e-4, levels=BENCH_LEVELS,
            )
        results[dev.type] = (res.transform, dict(nn.launch_counts))
    (tf_g, l_g), (tf_c, l_c) = results["cuda"], results["cpu"]
    if sum(l_c.values()) or l_g["nn1_compact"] == 0:
        raise AssertionError(f"launches: card {l_g}, CPU {l_c}")
    dt = float((tf_g.translation.cpu() - tf_c.translation).abs().max())
    dr = rot_angle(tf_g.linear.cpu().numpy(), tf_c.linear.numpy())
    emit(phase="icp_card_vs_cpu", height=120, width=160, card_launches=l_g,
         max_translation_diff_m=dt, max_rotation_diff_rad=dr)
    if not (dt < 1e-4 and dr < 1e-4):
        raise AssertionError(f"card and CPU registrations differ by {dt} m / {dr} rad")


REPLACES = {
    "coalesced_gather": "cilantro_tpu/core/coalesced.py:137",
    "project_to_rotation": "cilantro_tpu/core/transforms.py:147",
    "nn1_fused": "cilantro_tpu/neighbors/pallas_nn.py:151",
    "nn1_masked": "cilantro_tpu/neighbors/pallas_nn.py:247",
    "nn1_compact": "cilantro_tpu/neighbors/pallas_nn.py:363",
    "knn_full": "cilantro_tpu/neighbors/pallas_nn.py:861",
    "knn_compact": "cilantro_tpu/neighbors/pallas_nn.py:821",
    "scale2": "tools/wide_row_probe.py:160",
}


# ---------------------------------------------------------------------------
# The pool pipeline and its gather kernel.
# ---------------------------------------------------------------------------


def pool_config():
    from cilantro_tpu_torch.slam.fusion import FusionConfig

    return FusionConfig(localize_stride=2)


@contextlib.contextmanager
def gather_replaced(fn):
    """A context in which the pool pipeline's gathers call ``fn``."""
    from unittest import mock

    from cilantro_tpu_torch.correspondence import projective
    from cilantro_tpu_torch.slam import fusion

    with mock.patch.object(fusion, "coalesced_gather", fn), \
            mock.patch.object(projective, "coalesced_gather", fn):
        yield


def gather_site(src, idx) -> str:
    """The call site of a main-path gather, told by its shapes: the ICP
    target is 8 wide, integrate gathers H·W rows of the pool, the update
    gathers a row of the frame for each pool slot."""
    if src.shape[1] == 8:
        return "icp_projective"
    return "inverse_gather_update" if idx.shape[0] == POOL_CAPACITY else "integrate_rows"


def pool_main_path(depths, gt, k, card):
    """Phase 10: ``run_fusion_sequence`` on the 16 frames, recording the
    first ``(src, idx)`` of each gather call site; then a repeat for the
    host clock's spread and the same sequence with the gather replaced by
    its plain version (no launch, the same bits)."""
    from cilantro_tpu_torch.core import coalesced as cg
    from cilantro_tpu_torch.slam.driver import ate_rmse, run_fusion_sequence

    streams = {}
    gather = cg.coalesced_gather

    def recording(src, idx):
        streams.setdefault(gather_site(src, idx), (src, idx))
        return gather(src, idx)

    def run():
        return run_fusion_sequence(depths, k, map_capacity=POOL_CAPACITY,
                                   cfg=pool_config(), device="cuda")

    cg.reset_launch_counts()
    with gather_replaced(recording):
        fmap, met = run()
    torch.cuda.synchronize()
    launches = cg.launch_counts["coalesced_gather"]
    tracked = FRAMES - 1
    want = 2 * tracked + sum(met.icp_iterations[1:])
    if launches != want:
        raise AssertionError(f"pool main path: {launches} gather launches, want 2·{tracked} + ICP = {want}")
    if sorted(streams) != ["icp_projective", "integrate_rows", "inverse_gather_update"]:
        raise AssertionError(f"pool main path reached the gather from {sorted(streams)}")
    ate = ate_rmse(met.poses, gt, device="cuda")
    live = fmap.data[fmap.valid]
    if not ate < 2e-4:
        raise AssertionError(f"pool ATE {ate} m not below 2e-4 m")
    if not (met.num_map_points > 0.9 * H * W and bool(torch.isfinite(live[:, 0:6]).all())):
        raise AssertionError(f"pool map has {met.num_map_points} live points or non-finite values")
    _, met2 = run()
    cg.reset_launch_counts()
    with gather_replaced(cg.coalesced_gather_plain):
        fmap_plain, met_plain = run()
    torch.cuda.synchronize()
    if cg.launch_counts["coalesced_gather"] != 0:
        raise AssertionError("the pool run with the plain gather launched the gather kernel")
    same = all(np.array_equal(a, b) for a, b in zip(met.poses, met_plain.poses)) and torch.equal(
        fmap.data.view(torch.int32), fmap_plain.data.view(torch.int32)
    )
    if not same:
        raise AssertionError("the gather kernel and its plain version gave different poses or pools")
    spf = met.seconds_per_frame
    emit(
        phase="pool_main_path", pipeline="pool", frames=FRAMES, height=H, width=W,
        map_capacity=POOL_CAPACITY, localize_stride=2,
        launches={"coalesced_gather": launches}, icp_iterations=met.icp_iterations,
        ms_per_frame=spf * 1e3, frames_per_s=1.0 / spf,
        ms_per_frame_repeat=met2.seconds_per_frame * 1e3, frames_per_s_repeat=1.0 / met2.seconds_per_frame,
        ms_per_frame_plain_gather=met_plain.seconds_per_frame * 1e3,
        ate_m=ate, map_points=met.num_map_points, plain_gather_bit_identical=True, card=card,
    )
    return launches, streams, met


# Every gather stream a phase held bit for bit, by label: ``(src, idx)``
# for the A/B of the gather's designs (phase 37).
GATHER_STREAMS: dict = {}


def gather_bytes(src, idx) -> dict:
    """The gather's bytes: each index read once, each output row written
    once, and either each distinct source row read once (``bytes``, the
    bound reported from the start) or each distinct 64-byte segment of
    ``src`` that the clamped indices touch (``bytes_64b``: the memory
    system fetches whole segments, so rows 32 bytes wide at a stride of
    two move twice their bytes)."""
    n, w = idx.shape[0], src.shape[1]
    rows = torch.unique(idx.clamp(0, src.shape[0] - 1).long())
    off, row_bytes = src.data_ptr() % 64, w * src.element_size()
    segments = int(torch.unique(torch.cat([(off + rows * row_bytes) // 64,
                                           (off + (rows + 1) * row_bytes - 1) // 64])).numel())
    moved = n * 4 + n * row_bytes
    return dict(rows=n, width=w, distinct_rows=int(rows.numel()), segments_64b=segments,
                bytes=moved + int(rows.numel()) * row_bytes, bytes_64b=moved + segments * 64)


def gather_cases(streams) -> dict:
    """Phase 11's cases: the recorded streams, a uniformly random one and
    one with 30% wildcards at the integrate shape."""
    rng = np.random.default_rng(1)
    src, idx = streams["integrate_rows"]
    c = src.shape[0]
    rand = torch.from_numpy(rng.integers(0, c, idx.shape[0]).astype(np.int32)).to(idx.device)
    wild = idx.clone()
    wild[torch.from_numpy(rng.random(idx.shape[0]) < 0.3).to(idx.device)] = -1
    return dict(streams, random=(src, rand), wildcards_30pct=(src, wild))


def gather_kernel_checks(cg, streams):
    """Phase 11: the gather kernel against its plain version, bit for bit,
    on the three recorded streams, a uniformly random one and one with 30%
    wildcards at the integrate shape; timed beside the plain version,
    ``torch.index_select`` (the yardstick) and both byte bounds of
    :func:`gather_bytes`."""
    out = {}
    for label, (s, i) in gather_cases(streams).items():
        GATHER_STREAMS[f"phase 11, {label}"] = (s, i)
        kernel = lambda: cg.coalesced_gather(s, i)  # noqa: E731
        plain = lambda: cg.coalesced_gather_plain(s, i)  # noqa: E731
        library = lambda: torch.index_select(s, 0, i.clamp(0, s.shape[0] - 1))  # noqa: E731
        k_out, p_out = kernel(), plain()
        torch.cuda.synchronize()
        assert_same_bits(f"coalesced_gather ({label})", [k_out], [p_out])
        sizes = gather_bytes(s, i)
        entry = dict(
            name="coalesced_gather", route="cuda", source="cilantro_tpu_torch/csrc/gather_kernels.cu",
            replaces="cilantro_tpu/core/coalesced.py:137", max_abs_err=max_abs_err(k_out, p_out),
            ms=device_ms(kernel), plain_ms=device_ms(plain),
            bound_ms=sizes["bytes"] / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=device_ms(library),
            library_is="torch.index_select of the clamped indices (a yardstick; the port never calls it)",
            bound_64b_ms=sizes["bytes_64b"] / HBM_BYTES_PER_S * 1e3, src_rows=s.shape[0],
            wildcards=int((i < 0).sum()), **sizes,
        )
        emit(phase="gather_kernel_vs_plain", stream=label, tolerance="bit-exact", **entry)
        out[label] = entry
    return out


def pool_stage_split(fusion, depths, k, dev, frames=6):
    """Phase 12a: host time of frame prep, localize and integrate per
    frame (each ended with a synchronise), median over the steady frames."""
    from cilantro_tpu_torch.core.rgbd import depth_to_points_normals
    from cilantro_tpu_torch.core.transforms import identity

    cfg = pool_config()
    d = [torch.as_tensor(x, device=dev) for x in depths[: frames + 2]]
    f0 = depth_to_points_normals(d[0], k)
    fmap = fusion.init_map_from_frame(POOL_CAPACITY, f0[0], f0[1], None, f0[2])
    pose, packed = identity(3, device=dev), None
    sub = (torch.arange(0, H, 2, device=dev)[:, None] * W + torch.arange(0, W, 2, device=dev)).reshape(-1)
    split = {"frame_prep": [], "localize": [], "integrate": []}
    for depth in d[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pts, nrm, valid = depth_to_points_normals(depth, k)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pose, _ = fusion.localize(fmap, pts[sub], nrm[sub], valid[sub], pose, k, height=H, width=W,
                                  cfg=cfg, packed_target=packed)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        fmap, _, packed = fusion.integrate_frame_with_imap(fmap, pts, nrm, None, valid, pose, k,
                                                           height=H, width=W, cfg=cfg)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for name, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
            split[name].append(dt * 1e3)
    # The first frame renders its own target and meets cold caches.
    return {name: statistics.median(v[1:]) for name, v in split.items()}


def pool_profile(fusion, depths, k, dev, ms_per_frame, frames=6):
    """Phase 12b: :func:`profile_once` over ``frames`` steady frames of the
    pool pipeline, per frame."""
    from cilantro_tpu_torch.core.rgbd import depth_to_points_normals
    from cilantro_tpu_torch.core.transforms import identity

    cfg = pool_config()
    clouds = [depth_to_points_normals(torch.as_tensor(x, device=dev), k) for x in depths[: frames + 2]]
    fmap = fusion.init_map_from_frame(POOL_CAPACITY, *clouds[0][:2], None, clouds[0][2])
    step = fusion.fusion_step(fmap, *clouds[1][:2], None, clouds[1][2], identity(3, device=dev), k,
                              height=H, width=W, cfg=cfg)
    state = {"fmap": step[0], "pose": step[1], "packed": step[4]}

    def run():
        for pts, nrm, valid in clouds[2:]:
            fmap, pose, _, _, packed = fusion.fusion_step(
                state["fmap"], pts, nrm, None, valid, state["pose"], k,
                cached_packed_target=state["packed"], height=H, width=W, cfg=cfg,
            )
            state.update(fmap=fmap, pose=pose, packed=packed)

    return profile_once(run, ms_per_frame, runs=len(clouds) - 2)


def pool_driver_frames(depths, k):
    """Phase 12c: host ms of each tracked frame of ``run_fusion_sequence``
    (from ``on_frame`` timestamps, each taken after a synchronise), and the
    steady ms/frame with the gather kernel and with its plain version in 5
    pairs whose order alternates (kernel-plain, plain-kernel, ...): whether
    the kernel moves the frame beyond the host clock's spread."""
    from cilantro_tpu_torch.core import coalesced as cg
    from cilantro_tpu_torch.slam.driver import run_fusion_sequence

    def ms_per_frame(kernel, **kw):
        with gather_replaced(cg.coalesced_gather if kernel else cg.coalesced_gather_plain):
            _, met = run_fusion_sequence(depths, k, map_capacity=POOL_CAPACITY,
                                         cfg=pool_config(), device="cuda", **kw)
        return met.seconds_per_frame * 1e3

    stamps = []
    ms_per_frame(True, on_frame=lambda fi, fmap, pose: stamps.append(time.perf_counter()))
    per_frame = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    turns = {True: [], False: []}
    for pair in range(5):
        for kernel in ((True, False) if pair % 2 == 0 else (False, True)):
            turns[kernel].append(ms_per_frame(kernel))
    return {
        "frame_ms_after_first": per_frame, "frame_ms_median": statistics.median(per_frame),
        "ms_per_frame_kernel": turns[True], "ms_per_frame_plain_gather": turns[False],
        "median_kernel": statistics.median(turns[True]),
        "median_plain_gather": statistics.median(turns[False]),
        "pairs_kernel_faster": sum(a < b for a, b in zip(turns[True], turns[False])),
    }


def pool_card_vs_cpu(cg, depths, k, card_poses):
    """Phase 13: the first frames through the same entry point on the CPU
    (the plain versions): no launch, poses as the card's."""
    from cilantro_tpu_torch.slam.driver import run_fusion_sequence

    cg.reset_launch_counts()
    _, met = run_fusion_sequence(depths[:CPU_FRAMES], k, map_capacity=POOL_CAPACITY,
                                 cfg=pool_config(), device="cpu")
    if cg.launch_counts["coalesced_gather"] != 0:
        raise AssertionError("the CPU pool run launched the gather kernel")
    dt = max(float(np.abs(a[:3, 3] - b[:3, 3]).max()) for a, b in zip(card_poses, met.poses))
    dr = max(rot_angle(a[:3, :3], b[:3, :3]) for a, b in zip(card_poses, met.poses))
    emit(phase="pool_card_vs_cpu", frames=CPU_FRAMES, max_translation_diff_m=dt,
         max_rotation_diff_rad=dr, icp_iterations_cpu=met.icp_iterations)
    if not (dt < 1e-4 and dr < 1e-4):
        raise AssertionError(f"card and CPU pool poses differ by {dt} m / {dr} rad")


# ---------------------------------------------------------------------------
# The neighbour engines, kNN normals and the two kNN kernels.
# ---------------------------------------------------------------------------

KNN_K = 12
FULL_PATH_POINTS = 8192  # below it Q·M < 2^26: knn takes the full kernel
# Kernel ms of the previous kNN kernels (one thread per query, per-key
# insertion into shared-memory slots) on the phase 18 cases, NVIDIA H100
# 80GB HBM3 at 700 W, PERF.md §6 table: (kernel, case, k, exclude_diag) -> ms.
PREVIOUS_KNN_MS = {
    ("knn_compact", "phase 14 list", 12, False): 13.354623794555664,
    ("knn_compact", "phase 14 list", 12, True): 13.241791725158691,
    ("knn_full", "phase 16", 12, False): 4.936319828033447,
    ("knn_full", "random 4096", 1, False): 0.39635199308395386,
    ("knn_full", "random 4096", 12, False): 1.0279359817504883,
    ("knn_full", "random 4096", 65, False): 8.757375717163086,
}


def host_ms(fn, reps=3) -> float:
    """Median host-clock ms of ``fn`` (synchronised before and after), for
    functions that read results back to the host themselves."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def frame_cloud(depth, k, dev):
    """A frame back-projected by ``depth_to_points``: H·W rows, invalid
    pixels masked (and at 1e30)."""
    from cilantro_tpu_torch.core.containers import PointCloud
    from cilantro_tpu_torch.core.rgbd import depth_to_points

    pts, valid = depth_to_points(torch.as_tensor(depth, device=dev), k)
    return PointCloud(points=pts, valid=valid)


@contextlib.contextmanager
def compact_calls(fk):
    """Record every ``_knn_compact`` call of the pruned engines (one per
    radius-doubling round of ``knn_pruned``, one per ``radius_search_pruned``):
    its operands, survivors and budget."""
    from unittest import mock

    calls = []
    inner = fk._knn_compact

    def recording(qp, kp, tile_mask, *, k, budget, tile_q, tile_m, exclude_diag=False, ids=None):
        ids = fk._live_pairs(tile_mask) if ids is None else ids
        calls.append(dict(qp=qp, kp=kp, mask=tile_mask, survivors=int(ids.shape[0]), budget=budget,
                          tile_q=tile_q, tile_m=tile_m))
        return inner(qp, kp, tile_mask, k=k, budget=budget, tile_q=tile_q, tile_m=tile_m,
                     exclude_diag=exclude_diag, ids=ids)

    with mock.patch.object(fk, "_knn_compact", recording):
        yield calls


def round_stats(calls):
    """Rounds, visited tile and point pairs and full-kernel fallbacks of
    recorded compact calls."""
    kept = [c for c in calls if c["survivors"] <= c["budget"]]
    return {
        "rounds": len(calls),
        "survivors_per_round": [c["survivors"] for c in calls],
        "budget": calls[0]["budget"] if calls else None,
        "full_fallbacks": len(calls) - len(kept),
        "visited_tile_pairs": sum(c["survivors"] for c in kept),
        "visited_point_pairs": sum(c["survivors"] * c["tile_q"] * c["tile_m"] for c in kept),
    }


def median_abs_cos(a, b, both) -> float:
    return float(torch.median(torch.abs(torch.sum(a[both] * b[both], dim=-1))))


def knn_normals_main_path(fk, cloud, ref_normals, ref_valid, card):
    """Phase 14: ``with_normals_knn(k=12)`` on the 307,200-point frame, the
    slice's main path: the compact kernel must run; rounds, visited pairs,
    host ms after a warm-up, the device's busy share, and the median |cos|
    against the depth image's normals (> 0.9)."""
    cloud.with_normals_knn(KNN_K)  # warm-up
    torch.cuda.synchronize()
    fk.reset_launch_counts()
    with compact_calls(fk) as calls:
        t0 = time.perf_counter()
        out = cloud.with_normals_knn(KNN_K)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    launches = dict(fk.launch_counts)
    if launches["knn_compact"] == 0:
        raise AssertionError(f"kNN normals did not run the compact kernel: {launches}")
    both = out.valid & ref_valid
    cos = median_abs_cos(out.normals, ref_normals, both)
    if not (cos > 0.9 and bool(torch.isfinite(out.normals).all())):
        raise AssertionError(f"kNN normals: median |cos| {cos} to the depth normals, want > 0.9")
    ms_repeat = host_ms(lambda: cloud.with_normals_knn(KNN_K), reps=5)
    emit(phase="knn_normals_main_path", points=int(cloud.capacity), valid=int(cloud.valid.sum()),
         k=KNN_K, launches=launches, **round_stats(calls), ms=ms, ms_repeat=ms_repeat,
         normals_valid=int(out.valid.sum()), compared=int(both.sum()),
         median_abs_cos_to_depth_normals=cos, card=card)
    try:
        emit(phase="knn_normals_profile", card=card,
             **profile_once(lambda: cloud.with_normals_knn(KNN_K), ms_repeat))
    except Exception as e:  # informational phase: report and go on
        emit(phase="knn_normals_profile", device_busy="not measured", error=f"{type(e).__name__}: {e}")
    return out, launches, calls[0]


def eigh_yardstick(cloud, card):
    """Phase 14b (informational): the normals' batched 3×3 eigensolver,
    ``eigh_sym`` (Jacobi, plain tensor ops) on every neighbourhood of the
    frame, beside ``torch.linalg.eigh`` (cuSOLVER) on 16,384 of them and
    whether cuSOLVER takes 32,768."""
    from cilantro_tpu_torch.core.covariance import eigh_sym, neighborhood_mean_cov
    from cilantro_tpu_torch.neighbors.api import knn_search

    nb = knn_search(cloud.points, cloud.points, KNN_K, query_valid=cloud.valid, key_valid=cloud.valid)
    _, cov, _ = neighborhood_mean_cov(cloud.points, nb.indices, nb.mask, 3)
    record = {"matrices": int(cov.shape[0]), "eigh_sym_ms": device_ms(lambda: eigh_sym(cov)),
              "linalg_eigh_16384_ms": device_ms(lambda: torch.linalg.eigh(cov[:16384]))}
    w, v = eigh_sym(cov[:16384])
    w_ref, v_ref = torch.linalg.eigh(cov[:16384])
    record["max_eigenvalue_diff"] = float((w - w_ref).abs().max())
    record["min_abs_cos_smallest_vector"] = float(torch.abs(torch.sum(v[..., 0] * v_ref[..., 0], -1)).min())
    try:
        torch.linalg.eigh(cov[:32768])
        torch.cuda.synchronize()
        record["linalg_eigh_32768"] = "ran"
    except RuntimeError as e:
        record["linalg_eigh_32768"] = f"{type(e).__name__}: {str(e)[:120]}"
    emit(phase="eigh_yardstick", card=card, **record)


def knn_normals_registration(fk, nn, icp_mod, src, cloud0, rel):
    """Phase 15: frame 1 onto frame 0 with ``icp_multires`` and the bench
    levels, the destination normals from ``with_normals_knn`` (computed
    inside the counted run): held to phase 6's bounds."""
    sp, _, sv = src

    def run():
        dst = cloud0.with_normals_knn(KNN_K)
        return icp_mod.icp_multires(
            sp, dst.points, dst_normals=dst.normals, src_valid=sv, dst_valid=dst.valid,
            metric="combined", convergence_tol=1e-4, levels=BENCH_LEVELS,
        )

    fk.reset_launch_counts()
    nn.reset_launch_counts()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {"knn_compact": fk.launch_counts["knn_compact"], "knn_full": fk.launch_counts["knn_full"],
                "nn1_compact": nn.launch_counts["nn1_compact"]}
    dt, dr = gt_error(res.transform.linear, res.transform.translation, rel)
    emit(phase="knn_normals_registration", pipeline="with_normals_knn + icp_multires",
         launches=launches, ms=ms, ms_repeat=host_ms(run), translation_error_m=dt, rotation_error_rad=dr,
         iterations=int(res.iterations))
    if launches["knn_compact"] == 0 or launches["nn1_compact"] == 0:
        raise AssertionError(f"normals + registration launches {launches}")
    if not (dt < 5e-4 and dr < 1e-4):
        raise AssertionError(f"registration with kNN normals off by {dt} m / {dr} rad")


def knn_full_path(fk, cloud0):
    """Phase 16: ``with_normals_knn(k=12)`` on frame 0 grid-downsampled at
    the smallest bin (2 cm upward in 2.5 mm steps) that leaves fewer than
    8,192 points, so that ``knn`` takes the full kernel."""
    from cilantro_tpu_torch.core.containers import compact

    for i in range(80):
        bin_size = 0.02 + 0.0025 * i
        down = compact(cloud0.grid_downsampled(bin_size))
        if down.capacity < FULL_PATH_POINTS:
            break
    down.with_normals_knn(KNN_K)  # warm-up
    torch.cuda.synchronize()
    fk.reset_launch_counts()
    t0 = time.perf_counter()
    out = down.with_normals_knn(KNN_K)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(fk.launch_counts)
    if launches["knn_full"] == 0 or launches["knn_compact"] != 0:
        raise AssertionError(f"the downsampled kNN normals launched {launches}")
    if not (bool(torch.isfinite(out.normals).all()) and int(out.valid.sum()) > 0.9 * down.capacity):
        raise AssertionError("the downsampled kNN normals are not finite or mostly invalid")
    emit(phase="knn_full_path", bin_size=bin_size, points=int(down.capacity), k=KNN_K,
         launches=launches, ms=ms, normals_valid=int(out.valid.sum()))
    return down, launches


def bench_neighbour_rows(fk, cloud0, card):
    """Phase 17 (informational): the JAX bench's neighbour rows on the
    frame's valid points, host ms after a warm-up, peak device memory and
    the profiler's device kernel ms; ``with_normals_radius`` must take the
    compact kernel at a cap of 16 and the grid search (plain tensor code,
    no kernel) at its default cap of 32."""
    from cilantro_tpu_torch.core.containers import compact
    from cilantro_tpu_torch.neighbors.bruteforce import knn

    cloud = compact(cloud0)
    q = cloud.points
    rows = {  # label: (run, the compact kernel must launch)
        "knn_k10_exclude_self": (lambda: knn(q, q, 10, exclude_self=True), True),
        "radius_search_pruned_1cm_cap10_exclude_self":
            (lambda: fk.radius_search_pruned(q, q, 0.01, 10, exclude_self=True), True),
        "with_normals_radius_1cm_cap16": (lambda: cloud.with_normals_radius(0.01, max_neighbors=16), True),
        "with_normals_radius_1cm_cap32_grid": (lambda: cloud.with_normals_radius(0.01), False),
    }
    for label, (run, on_kernel) in rows.items():
        run()  # warm-up
        torch.cuda.synchronize()
        fk.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with compact_calls(fk) as calls:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
        launches = dict(fk.launch_counts)
        if on_kernel and launches["knn_compact"] == 0:
            raise AssertionError(f"{label} did not run the compact kernel: {launches}")
        if not on_kernel and sum(launches.values()):
            raise AssertionError(f"{label} should take the grid search, launched {launches}")
        try:
            prof = profile_once(run, ms)
            prof = {key: prof[key] for key in ("device_kernel_ms", "device_idle_share") if key in prof} or prof
        except Exception as e:  # informational: report and go on
            prof = {"device_busy": "not measured", "error": f"{type(e).__name__}: {e}"}
        emit(phase="bench_neighbour_row", row=label, points=int(q.shape[0]), launches=launches,
             **round_stats(calls), host_ms=ms, peak_device_mib_above_start=peak_mib, **prof, card=card)


def knn_kernel_checks(fk, nn, first_round, down):
    """Phase 18: each kNN kernel against its plain version on the card, bit
    for bit, timed as in phase 2 beside its arithmetic bound: the compact
    kernel at phase 14's first-round pair list (k = 12, plain and with the
    diagonal excluded), the compact wrapper with a budget one short of the
    survivors of 16 query tiles (the full-kernel fallback), the full kernel
    at phase 16's shape and at a 4096 × 4096 random cloud with k = 1, 12
    and 65, beside ``torch.cdist`` + ``topk`` as a two-call yardstick."""
    out = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def record(name, case, shape, kernel, plain, pairs, nbytes, k, design, diag=False, library=None,
               plain_syncs=False, **extra):
        """``kernel``: the whole wrapper, checked bit for bit and timed."""
        k_out, p_out = kernel(), plain()
        torch.cuda.synchronize()
        assert_same_bits(name, k_out, p_out)
        # The nn1 count; the merges of the keys that enter come on top.
        bound_ms, bound_by = nn1_bound(pairs, nbytes)
        entry = dict(
            name=name, route="cuda", source="cilantro_tpu_torch/csrc/knn_kernels.cu",
            replaces=REPLACES[name], max_abs_err=max(max_abs_err(a, b) for a, b in zip(k_out, p_out)),
            ms=device_ms(kernel), plain_ms=host_ms(plain) if plain_syncs else device_ms(plain),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None if library is None else device_ms(library), pairs=pairs, bytes=nbytes,
        )
        if plain_syncs:
            entry["plain_timer"] = "host clock, median of 3 (the plain version reads its pair list back)"
        before = PREVIOUS_KNN_MS.get((name, case, k, diag))
        emit(phase="knn_kernel_vs_plain", tolerance="bit-exact", case=case, shape=shape, k=k,
             exclude_diag=diag, **entry, bound_share=bound_ms / entry["ms"], design=design,
             previous_design_ms=before if before is not None else "not measured", **extra)
        return entry

    # Compact: the first round of the main path's kNN normals.
    qp, kp, mask = first_round["qp"], first_round["kp"], first_round["mask"]
    tq, tm, budget = first_round["tile_q"], first_round["tile_m"], first_round["budget"]
    qt, kt, fl = nn._compact_list(mask, budget)
    survivors = first_round["survivors"]
    n_qt = qp.shape[0] // tq

    def prep():
        return fk._compact_items(qt, kt, fl, n_qt, tq, tm, survivors)

    work = prep()
    items = work[2]
    work_stats = dict(items=int(items.shape[0]), real_items=int((items[:, 0] >= 0).sum()),
                      split_items=int((items[:, 3] > 1).sum()), split_items_bound=work[4])
    prep_ms = device_ms(prep)
    for kk, diag in ((KNN_K, False), (KNN_K, True), (1, False), (65, False)):
        io_bytes = (qp.numel() + kp.numel()) * 4 + 3 * 4 * budget + qp.shape[0] * kk * 8

        def wrapper():
            return fk.knn_compact_rows(qp, kp, qt, kt, fl, k=kk, tile_q=tq, tile_m=tm, exclude_diag=diag,
                                       max_live=survivors)

        # The wrapper builds its work on the card: no host sync.
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            wrapper()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        entry = record(
            "knn_compact", "phase 14 list",
            f"{qp.shape[0]}x{kp.shape[0]}, tiles {tq}x{tm}, {survivors} of {mask.numel()} pairs",
            wrapper, lambda: fk.knn_compact_rows_plain(qp, kp, qt, kt, fl, kk, tq, tm, diag),
            survivors * tq * tm, io_bytes, kk,
            fk.kernel_design("knn_compact", qp.shape[0], kp.shape[0], kk, tile_q=tq, tile_m=tm, sms=sms),
            diag=diag, plain_syncs=True, budget=budget,
            prep_ms=prep_ms,
            launch_ms=device_ms(lambda: fk._compact_launch(qp, kp, work, k=kk, tile_q=tq, tile_m=tm,
                                                           exclude_diag=diag)),
            timers="ms: the whole wrapper (work built on the card, then the launch); prep_ms: the "
                   "work alone; launch_ms: the launch with its scratch alone",
            partial_list_mib=work[4] * work[3] * kk * 8 / 2**20, **work_stats,
            library_is="none: no PyTorch call searches a list of tile pairs",
        )
        out.setdefault("knn_compact", entry)

    # The compact wrapper's fallback on 16 query tiles: the full kernel.
    sub_mask, sub_qp = mask[:16], qp[: 16 * tq]
    n = int(sub_mask.sum())
    before = dict(fk.launch_counts)
    got = fk._knn_compact(sub_qp, kp, sub_mask, k=KNN_K, budget=n - 1, tile_q=tq, tile_m=tm)
    torch.cuda.synchronize()
    routed = {name: fk.launch_counts[name] - before[name] for name in before}
    if routed != {"knn_full": 1, "knn_compact": 0}:
        raise AssertionError(f"the over-budget compact call launched {routed}")
    assert_same_bits("knn_compact fallback", got, fk.knn_full_rows_plain(sub_qp, kp, KNN_K))
    emit(phase="knn_compact_fallback", query_rows=int(sub_qp.shape[0]), budget=n - 1, survivors=n,
         launches=routed, tolerance="bit-exact", max_abs_err=0.0)

    # Full: phase 16's shape, then a random 4096-point cloud at three k.
    rng = np.random.default_rng(2)
    rand = torch.from_numpy(rng.uniform(-1, 1, (4096, 3)).astype(np.float32)).cuda()
    cases = [("phase 16", down.points, down.valid, KNN_K)]
    cases += [("random 4096", rand, None, kk) for kk in (1, 12, 65)]
    for label, pts, valid, kk in cases:
        qp_f, kp_f = fk._augment(pts, pts, valid, 512, 2048)  # as knn_fused pads them
        p = pts if valid is None else pts[valid]
        entry = record(
            "knn_full", label, f"{label}: {qp_f.shape[0]}x{kp_f.shape[0]}",
            lambda: fk.knn_full_rows(qp_f, kp_f, k=kk), lambda: fk.knn_full_rows_plain(qp_f, kp_f, kk),
            pts.shape[0] ** 2, (qp_f.numel() + kp_f.numel()) * 4 + qp_f.shape[0] * kk * 8, kk,
            fk.kernel_design("knn_full", qp_f.shape[0], kp_f.shape[0], kk, sms=sms),
            library=lambda: torch.topk(torch.cdist(p, p), kk, dim=1, largest=False),
            library_is="torch.cdist + topk over the same points (two calls, a yardstick; the port never calls it)",
        )
        out.setdefault("knn_full", entry)
    return out


def knn_normals_card_vs_cpu(fk, k_small):
    """Phase 19: ``with_normals_knn(k=12)`` on a 160×120 frame on the card
    (the pruned kernel path) and on the CPU (the tiled scan, the
    counterpart of what JAX runs on a CPU): |cos| ≥ 0.999 on at least 99%
    of the points valid in both (the rest: near-tied neighbours swapped)."""
    from cilantro_tpu_torch.slam.driver import synthetic_sequence

    depths, _ = synthetic_sequence(1, 120, 160, k_small, seed=0)
    out = {}
    for dev in ("cuda", "cpu"):
        fk.reset_launch_counts()
        out[dev] = (frame_cloud(depths[0], k_small, torch.device(dev)).with_normals_knn(KNN_K),
                    dict(fk.launch_counts))
    (g, l_g), (c, l_c) = out["cuda"], out["cpu"]
    if sum(l_c.values()) or l_g["knn_compact"] == 0:
        raise AssertionError(f"launches: card {l_g}, CPU {l_c}")
    both = g.valid.cpu() & c.valid
    cos = torch.abs(torch.sum(g.normals.cpu()[both] * c.normals[both], dim=-1))
    share = float((cos >= 0.999).float().mean())
    emit(phase="knn_normals_card_vs_cpu", height=120, width=160, card_launches=l_g,
         compared=int(both.sum()), share_abs_cos_ge_0_999=share, min_abs_cos=float(cos.min()),
         valid_card=int(g.valid.sum()), valid_cpu=int(c.valid.sum()))
    if not share >= 0.99:
        raise AssertionError(f"card and CPU kNN normals agree on {share} of the points, want >= 0.99")


def probe_kernel_check():
    """Phase 20: ``scale2`` (the wide-row probe's copy kernel) once on the
    (CAP/8, 128) pool view, bit for bit against ``2.0 * x``, timed beside
    ``torch.mul`` and its byte bound (each element read and written once)."""
    from cilantro_tpu_torch.tools import wide_row_probe as probe

    x = torch.from_numpy(np.random.default_rng(3).standard_normal((POOL_CAPACITY // 8, 128))
                         .astype(np.float32)).cuda()
    probe.reset_launch_counts()
    got = probe.scale2(x)
    torch.cuda.synchronize()
    launches = probe.launch_counts["scale2"]
    want = probe.scale2_plain(x)
    assert_same_bits("scale2", [got], [want])
    nbytes = 2 * x.numel() * 4
    # Kernel and torch.mul in five alternating pairs (kernel first, then mul
    # first): is the kernel slower than the one PyTorch call?
    kernel, library = lambda: probe.scale2(x), lambda: torch.mul(x, 2.0)
    pairs = []
    for i in range(5):
        first, second = (kernel, library) if i % 2 == 0 else (library, kernel)
        a, b = device_ms(first), device_ms(second)
        pairs.append((a, b) if i % 2 == 0 else (b, a))
    ms = statistics.median(p[0] for p in pairs)
    library_ms = statistics.median(p[1] for p in pairs)
    entry = dict(
        name="scale2", route="cuda", source="cilantro_tpu_torch/csrc/probe_kernels.cu",
        replaces=REPLACES["scale2"], launches=launches, max_abs_err=max_abs_err(got, want),
        ms=ms, plain_ms=device_ms(lambda: probe.scale2_plain(x)),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=library_ms, bytes=nbytes,
        path="wide_row_probe copy, one launch",
    )
    emit(phase="probe_kernel_vs_plain", tolerance="bit-exact", shape=list(x.shape),
         library_is="torch.mul(x, 2.0) (a yardstick)",
         alternating_pairs_kernel_library_ms=pairs,
         kernel_slower_in_pairs=sum(a > b for a, b in pairs), **entry)
    return entry


# ---------------------------------------------------------------------------
# The rotation kernel and the scanned drivers (CUDA-graph replays).
# ---------------------------------------------------------------------------

# Operations of one project_to_rotation (csrc/rotation_kernels.cu): AᵀA 45,
# 12 Jacobi rotations of 42, the vectors and the product 148; a division or
# square root counts one.
ROTATION_OPS = 697
ROTATION_BYTES = 72  # one 3x3 float32 matrix read, one written


@contextlib.contextmanager
def rotation_recorded(kept: dict):
    """A context in which each ``reproject_rigid`` keeps the matrix it
    projects in ``kept["project_to_rotation"]``."""
    from unittest import mock

    from cilantro_tpu_torch.core import transforms as tfm

    real = tfm.project_to_rotation

    def recording(linear):
        kept["project_to_rotation"] = linear
        return real(linear)

    with mock.patch.object(tfm, "project_to_rotation", recording):
        yield


def rotation_kernel_check(tfm, path_linear):
    """Phase 3c: the rotation kernel against its plain version, bit for
    bit, on the matrix of its last call on the splat path and on 4096
    random matrices, timed as in phase 2 beside its bound; the SVD route it
    replaced (which syncs) by the host clock. Returns the path case's
    kernels-line entry."""
    rng = np.random.default_rng(1)
    batch = torch.from_numpy(rng.standard_normal((4096, 3, 3)).astype(np.float32)).to(path_linear.device)

    def svd_route(x):
        u, _, vt = torch.linalg.svd(x)
        sign = torch.where(torch.linalg.det(u @ vt) < 0, -1.0, 1.0)
        return torch.cat([u[..., :, :-1], u[..., :, -1:] * sign[..., None, None]], -1) @ vt

    entry = None
    for case, x in (("splat path, last GN iteration", path_linear), ("4096 random matrices", batch)):
        kernel = lambda: tfm.project_to_rotation(x)  # noqa: E731
        plain = lambda: tfm.project_to_rotation_plain(x)  # noqa: E731
        k_out, p_out = kernel(), plain()
        torch.cuda.synchronize()
        assert_same_bits(f"project_to_rotation, {case}", (k_out,), (p_out,))
        n = x.numel() // 9
        by_bytes = ROTATION_BYTES * n / HBM_BYTES_PER_S
        by_ops = ROTATION_OPS * n / F32_OPS_PER_S
        rec = dict(
            name="project_to_rotation", route="cuda", source="cilantro_tpu_torch/csrc/rotation_kernels.cu",
            replaces="cilantro_tpu/core/transforms.py:147", max_abs_err=max_abs_err(k_out, p_out),
            ms=device_ms(kernel), plain_ms=device_ms(plain), bound_ms=max(by_bytes, by_ops) * 1e3,
            bound_by="bytes" if by_bytes >= by_ops else "operations", library_ms=None,
        )
        emit(phase="kernel_vs_plain", tolerance="bit-exact", case=case, matrices=n,
             note="replaces jnp.linalg.svd inside XLA (no Pallas kernel); no single PyTorch call",
             svd_route_host_ms=host_ms(lambda: svd_route(x)),
             svd_route_max_abs_diff=max_abs_err(k_out, svd_route(x)), **rec)
        entry = entry or rec
    return entry


def no_host_sync(name, fn):
    """Run ``fn`` once under ``torch.cuda.set_sync_debug_mode("error")``:
    a step that a graph capture must hold may not wait on the host."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    emit(phase="no_host_sync", step=name)


def scanned_phase(name, run_loop, run_graph, loop_poses, gt, max_diff, want_launches, ate_bound,
                  loop_busy_ms, card):
    """Phases 21-22, shared: host loop and graph replay in two alternating
    pairs (loop, graph, graph, loop); the graph's poses against the host
    loop's of the main path; launches a replay; the GN or ICP iterations
    kept and masked; the device ms a frame of the graph (CUDA events), of
    the graph captured with one iteration (the masked iterations' cost is
    the difference over 5 iterations), of its kernels (the profiler; one
    driver call executes 4 runs of the frames and the warm-up step) and of
    the host loop's kernels (the main path's profile). ``run_graph(stats,
    iterations)`` runs the scanned driver with that iteration cap (None:
    the configuration's) and returns its poses and host s a frame."""
    from cilantro_tpu_torch.slam.driver import ate_rmse

    ms = {"loop": [], "graph": []}
    for kind in ("loop", "graph", "graph", "loop"):
        if kind == "loop":
            ms[kind].append(run_loop() * 1e3)
            continue
        stats = {}
        poses, spf = run_graph(stats, None)
        ms[kind].append(spf * 1e3)
    useful = stats["iterations"]
    n_it = want_launches["project_to_rotation"]
    masked = [n_it - u for u in useful]
    if stats["launches_per_frame"] != want_launches:
        raise AssertionError(f"{name}: launches a replay {stats['launches_per_frame']}, want {want_launches}")
    ate = ate_rmse(poses, gt, device="cuda")
    diff = float(np.abs(np.stack(poses) - np.stack(loop_poses)).max())
    if not ate < ate_bound:
        raise AssertionError(f"{name}: ATE {ate} m not below {ate_bound} m")
    if not diff <= max_diff:
        raise AssertionError(f"{name}: poses {diff} from the host loop's, bound {max_diff}")
    one = {}
    run_graph(one, 1)
    dev_ms = stats["device_seconds_per_frame"] * 1e3
    per_iteration_ms = (dev_ms - one["device_seconds_per_frame"] * 1e3) / (n_it - 1)
    try:
        busy = profile_once(lambda: run_graph({}, None), statistics.median(ms["graph"]),
                            runs=4 * len(useful) + 1)
    except Exception as e:  # informational: report and go on
        busy = {"device_busy": "not measured", "error": f"{type(e).__name__}: {e}"}
    frames = len(useful)
    emit(
        phase=name, captured=True, frames=frames,
        host_ms_per_frame_loop=ms["loop"], host_ms_per_frame_graph=ms["graph"],
        device_ms_per_frame_graph=dev_ms,
        device_ms_per_frame_graph_one_iteration=one["device_seconds_per_frame"] * 1e3,
        device_ms_per_iteration=per_iteration_ms,
        device_ms_masked_per_frame=statistics.mean(masked) * per_iteration_ms,
        device_busy_ms_per_frame_loop=loop_busy_ms,
        useful_iterations=useful, masked_iterations=masked,
        launches_per_replay=stats["launches_per_frame"],
        launches_per_run={k: v * frames for k, v in stats["launches_per_frame"].items()},
        ate_m=ate, max_pose_diff_vs_loop=diff,
        bit_identical_to_loop=bool(np.array_equal(np.stack(poses), np.stack(loop_poses))),
        graph_profile=busy, card=card,
    )
    return poses


def scanned_splat_path(sf, depths, gt, k, cfg, loop_poses, loop_busy_ms, card):
    """Phase 21: ``run_splat_sequence_scanned`` on phase 3's frames."""
    import dataclasses

    dev = torch.device("cuda")
    d = [torch.as_tensor(x, device=dev) for x in depths[:2]]
    smap = sf.init_splat_map(*sf._frame_images(d[0], k, H, W), cfg)
    no_host_sync("splat fusion step, graph form", lambda: sf._fusion_step_counted(
        smap, d[1], sf.identity(3, device=dev), k, cfg=cfg, loop="graph"))

    def run_loop():
        return sf.run_splat_sequence(depths, k, cfg=cfg, device="cuda")[2]

    def run_graph(stats, iterations):
        c = dataclasses.replace(cfg, icp_iterations=iterations or cfg.icp_iterations)
        _, poses, spf, per_frame = sf.run_splat_sequence_scanned(depths, k, cfg=c, device="cuda", stats=stats)
        if any(f != {n: stats["launches_per_frame"][n] for n in f} for f in per_frame):
            raise AssertionError("scanned splat: per-frame launch dicts disagree with the replay's")
        return poses, spf

    n = cfg.icp_iterations
    return scanned_phase(
        "scanned_splat", run_loop, run_graph, loop_poses, gt, 1e-5,
        {"window_read_codes": n, "splat_argmin2": 1, "flow_select_rows": 1, "project_to_rotation": n},
        2e-3, loop_busy_ms, card,
    )


def scanned_pool_path(depths, gt, k, loop_poses, loop_busy_ms, card):
    """Phase 22: ``run_fusion_sequence_scanned`` on phase 10's inputs."""
    import dataclasses

    from cilantro_tpu_torch.core.rgbd import depth_to_points_normals
    from cilantro_tpu_torch.core.transforms import identity
    from cilantro_tpu_torch.slam import fusion
    from cilantro_tpu_torch.slam.driver import run_fusion_sequence, run_fusion_sequence_scanned

    dev = torch.device("cuda")
    cfg = pool_config()
    p0, n0, v0 = depth_to_points_normals(torch.as_tensor(depths[0], device=dev), k)
    fmap = fusion.init_map_from_frame(POOL_CAPACITY, p0, n0, None, v0)
    pose0 = identity(3, device=dev)
    _, packed = fusion.seed_localize_target(fmap, pose0, k, H, W)
    p1, n1, v1 = depth_to_points_normals(torch.as_tensor(depths[1], device=dev), k)
    no_host_sync("pool fusion step, graph form", lambda: fusion.fusion_step(
        fmap, p1, n1, None, v1, pose0, k, cached_packed_target=packed, height=H, width=W,
        cfg=cfg, loop="graph"))

    def run_loop():
        return run_fusion_sequence(depths, k, map_capacity=POOL_CAPACITY, cfg=cfg,
                                   device="cuda")[1].seconds_per_frame

    def run_graph(stats, iterations):
        c = dataclasses.replace(cfg, icp_iterations=iterations or cfg.icp_iterations)
        _, met = run_fusion_sequence_scanned(depths, k, map_capacity=POOL_CAPACITY, cfg=c,
                                             device="cuda", stats=stats)
        stats["iterations"] = met.icp_iterations[1:]
        return met.poses, met.seconds_per_frame

    n = cfg.icp_iterations
    return scanned_phase(
        "scanned_pool", run_loop, run_graph, loop_poses, gt, 1e-4,
        {"coalesced_gather": 2 + n, "project_to_rotation": n}, 2e-4, loop_busy_ms, card,
    )


# ---------------------------------------------------------------------------
# The non-rigid warp (phases 23-25).
# ---------------------------------------------------------------------------

# The JAX bench's warp settings (bench.py:130-133, _WARP_KW) and its
# max_cg_iterations (bench.py:174-176).
WARP_KW = dict(max_corr_dist_sq=0.0025, point_weight=1.0, plane_weight=0.0, stiffness=50.0,
               max_iterations=10)
WARP_MAX_CG = 200
WARP_POINTS, WARP_SCALE, WARP_GRID, WARP_STREAMS = 120_000, 0.36, 0.025, 8
WARP_MAX_NODES = 8192 // 6  # nodes × 6 parameters ≤ 8192: solver="auto" takes the direct route
WARP_EVERY = 6  # phase 25: every 6th point, 20,000 of the 120,000

# Each kernel wrapper by the module names that call it: (kernel, module,
# attribute). The warp, fusion and SLAM backend modules and the projective
# search import two of them by name.
KERNEL_WRAPPERS = (
    ("knn_full", "cilantro_tpu_torch.neighbors.fused_knn", "knn_full_rows"),
    ("knn_compact", "cilantro_tpu_torch.neighbors.fused_knn", "knn_compact_rows"),
    ("nn1_fused", "cilantro_tpu_torch.neighbors.fused_nn", "fused_rows"),
    ("nn1_masked", "cilantro_tpu_torch.neighbors.fused_nn", "masked_rows"),
    ("nn1_compact", "cilantro_tpu_torch.neighbors.fused_nn", "compact_rows"),
    ("coalesced_gather", "cilantro_tpu_torch.core.coalesced", "coalesced_gather"),
    ("coalesced_gather", "cilantro_tpu_torch.correspondence.projective", "coalesced_gather"),
    ("coalesced_gather", "cilantro_tpu_torch.slam.fusion", "coalesced_gather"),
    ("project_to_rotation", "cilantro_tpu_torch.core.transforms", "project_to_rotation"),
    ("project_to_rotation", "cilantro_tpu_torch.registration.warp_field", "project_to_rotation"),
    ("project_to_rotation", "cilantro_tpu_torch.registration.warp_field_batched", "project_to_rotation"),
    ("project_to_rotation", "cilantro_tpu_torch.slam.pose_graph", "project_to_rotation"),
    ("project_to_rotation", "cilantro_tpu_torch.slam.bundle_adjustment", "project_to_rotation"),
)


def reset_all_counts():
    from cilantro_tpu_torch.core import coalesced, transforms
    from cilantro_tpu_torch.neighbors import fused_knn, fused_nn

    for mod in (coalesced, transforms, fused_knn, fused_nn):
        mod.reset_launch_counts()


def all_counts() -> dict:
    from cilantro_tpu_torch.core import coalesced, transforms
    from cilantro_tpu_torch.neighbors import fused_knn, fused_nn

    out = {}
    for mod in (fused_nn, coalesced, fused_knn, transforms):
        out.update(mod.launch_counts)
    return out


@contextlib.contextmanager
def last_kernel_calls(kept: dict, wrappers=KERNEL_WRAPPERS, key=lambda name, args, kwargs: name):
    """A context in which every kernel wrapper keeps the arguments of its
    last call in ``kept[key(kernel, args, kwargs)]`` (by default one call
    a kernel)."""
    import importlib
    from unittest import mock

    with contextlib.ExitStack() as stack:
        for name, module, attr in wrappers:
            mod = importlib.import_module(module)

            def recording(*args, _real=getattr(mod, attr), _name=name, **kwargs):
                kept[key(_name, args, kwargs)] = (args, kwargs)
                return _real(*args, **kwargs)

            stack.enter_context(mock.patch.object(mod, attr, recording))
        yield kept


def warp_inputs():
    """The full-width warp configuration's clouds: the source is
    ``tests/test_warp_field.py``'s height-field ``surface`` at 120,000
    points from ``default_rng(0)``, scaled by 0.36 (a 0.72 m patch; it
    stands in for the bench's frame_1.ply, which the repo does not carry);
    the target is the bench's bend (bench.py:160-162) and the B = 8 targets
    bench.py:164-169's."""
    rng = np.random.default_rng(0)
    xy = rng.uniform(-1, 1, (WARP_POINTS, 2)).astype(np.float32)
    z = (0.2 * np.sin(1.5 * xy[:, 0]) * np.cos(1.5 * xy[:, 1])).astype(np.float32)
    src = np.column_stack([xy, z]) * np.float32(WARP_SCALE)
    dst = warp_bend(src)
    dsts = []
    for b in range(WARP_STREAMS):
        d = src.copy()
        d[:, 2] += 0.02 * np.sin((8 + 0.5 * b) * src[:, 0] + 0.3 * b)
        d[:, 1] += 0.01 * np.cos((6 + 0.3 * b) * src[:, 0])
        dsts.append(d)
    return src, dst, np.stack(dsts)


def warp_bend(pts):
    out = pts.copy()
    out[:, 2] += 0.02 * np.sin(8.0 * pts[:, 0])
    out[:, 1] += 0.01 * np.cos(6.0 * pts[:, 0])
    return out


def warp_control_nodes(src_t, valid=None):
    """The bench's control graph nodes (bench.py:863-887): a 2.5 cm
    ``grid_downsample``, compacted to the occupied voxels, the capacity
    rounded up to a multiple of 32 (dead padding nodes at the origin)."""
    from cilantro_tpu_torch.core.containers import PointCloud
    from cilantro_tpu_torch.core.grid import grid_downsample

    ctrl = grid_downsample(PointCloud(points=src_t, valid=valid), WARP_GRID)
    occ = ctrl.points[ctrl.valid]
    cap = -(-occ.shape[0] // 32) * 32
    nodes = torch.zeros((cap, 3), device=src_t.device)
    nodes[: occ.shape[0]] = occ
    return nodes, torch.arange(cap, device=src_t.device) < occ.shape[0]


def warp_errors(warped, dst, src=None) -> dict:
    """Median and 95th percentile of the warped points' distance to their
    targets; with ``src`` (a :func:`warp_inputs` cloud) also the error's
    part along the patch's normal at each source point, which nearest-point
    correspondences observe, and the part along the patch, which they do
    not (the bench's y term slides points along the near-flat patch)."""
    err = np.asarray(warped) - dst
    dist = np.linalg.norm(err, axis=-1)
    out = {"median_m": float(np.median(dist)), "p95_m": float(np.percentile(dist, 95))}
    if src is not None:
        nrm = warp_normals(src)
        along = np.abs(np.sum(err * nrm, axis=-1))
        out.update(normal_median_m=float(np.median(along)), normal_p95_m=float(np.percentile(along, 95)),
                   tangential_median_m=float(np.median(np.sqrt(np.maximum(dist**2 - along**2, 0.0)))))
    return out


def warp_normals(src):
    """Unit normals of the :func:`warp_inputs` height field at ``src``."""
    u, v = 1.5 * src[:, 0] / WARP_SCALE, 1.5 * src[:, 1] / WARP_SCALE
    zx, zy = 0.3 * np.cos(u) * np.cos(v), -0.3 * np.sin(u) * np.sin(v)
    n = np.stack([-zx, -zy, np.ones_like(zx)], axis=-1)
    return n / np.linalg.norm(n, axis=-1, keepdims=True)


def normal_displacement(src, dst) -> float:
    """Median of the targets' displacement along the patch's normal."""
    return float(np.median(np.abs(np.sum((dst - src) * warp_normals(src), axis=-1))))


def best_host_ms(fn, reps=3) -> float:
    """Best host-clock ms of ``reps`` runs after a warm-up, each ended by a
    synchronise."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def chunked_cdist_min(q, k):
    """Each query's nearest key by ``torch.cdist`` + ``min`` over query
    chunks of at most 2^30 distances (4 GiB)."""
    rows = max(1, 2**30 // max(k.shape[0], 1))
    return [torch.cdist(q[i:i + rows], k).min(dim=1) for i in range(0, q.shape[0], rows)]


def _real_rows(qp, kp):
    """Query rows that are points (the augmented "1" column) and key rows
    that are live points (a "1" column and a finite norm), 3-D rows."""
    return int((qp[:, 4] == 1).sum()), int(((kp[:, 3] == 1) & (kp[:, 4] < 1e37)).sum())


def warp_kernel_checks(kept: dict, launches: dict, path: str, phase="warp_kernel_vs_plain",
                       quick_pairs=None) -> dict:
    """Each kernel that ``path`` launched, bit for bit against its plain
    version on the inputs of its last call on it, timed as in phase 2
    (plain versions by the host clock, median of 3: some read back)
    beside its bound: the nn1 count of operations a visited pair (the
    whole query × key product for the full kernels, the live tile pairs
    for the listed ones), bytes for the gather and the rotation. A call of
    ``quick_pairs`` pairs or more has its plain version timed on the one
    run that is compared, and no library yardstick (the fused nn1 plain
    version takes ~7 s at 307,200²; phase 31 times both at that shape)."""
    from cilantro_tpu_torch.core import coalesced as cg
    from cilantro_tpu_torch.core import transforms as tfm
    from cilantro_tpu_torch.neighbors import fused_knn as fk
    from cilantro_tpu_torch.neighbors import fused_nn as nn

    out = {}
    for name, (args, kwargs) in kept.items():
        if not launches.get(name):
            continue
        library = None
        extra = {}
        if name == "knn_full":
            qp, kp = args
            k, diag = kwargs["k"], kwargs.get("exclude_diag", False)
            kernel = lambda: fk.knn_full_rows(qp, kp, k=k, exclude_diag=diag)  # noqa: E731
            plain = lambda: fk.knn_full_rows_plain(qp, kp, k, diag)  # noqa: E731
            nq, nk = _real_rows(qp, kp)
            q, kk = -0.5 * qp[qp[:, 4] == 1, :3], kp[(kp[:, 3] == 1) & (kp[:, 4] < 1e37), :3]
            library = lambda: torch.topk(torch.cdist(q, kk), min(k, nk), dim=1, largest=False)  # noqa: E731
            pairs, nbytes = nq * nk, (qp.numel() + kp.numel()) * 4 + qp.shape[0] * k * 8
            extra = dict(k=k, exclude_diag=diag, query_rows=nq, key_rows=nk,
                         library_is="torch.cdist + topk over the same points (two calls, a yardstick)")
        elif name == "knn_compact":
            qp, kp, qt, kt, fl = args
            k, tq, tm = kwargs["k"], kwargs["tile_q"], kwargs["tile_m"]
            diag = kwargs.get("exclude_diag", False)
            live = int(((fl & 2) != 0).sum())
            kernel = lambda: fk.knn_compact_rows(qp, kp, qt, kt, fl, k=k, tile_q=tq, tile_m=tm,  # noqa: E731
                                                 exclude_diag=diag, max_live=live)
            plain = lambda: fk.knn_compact_rows_plain(qp, kp, qt, kt, fl, k, tq, tm, diag)  # noqa: E731
            pairs = live * tq * tm
            nbytes = (qp.numel() + kp.numel()) * 4 + 3 * 4 * qt.shape[0] + qp.shape[0] * k * 8
            extra = dict(k=k, exclude_diag=diag, live_tile_pairs=live, tiles=[tq, tm],
                         library_is="none: no PyTorch call visits only the surviving pairs")
        elif name in ("nn1_compact", "nn1_masked", "nn1_fused"):
            fn, plain_fn = {"nn1_compact": (nn.compact_rows, nn.compact_rows_plain),
                            "nn1_masked": (nn.masked_rows, nn.masked_rows_plain),
                            "nn1_fused": (nn.fused_rows, nn.fused_rows_plain)}[name]
            qp, kp = args[:2]
            kernel = lambda: fn(*args, **kwargs)  # noqa: E731
            if name == "nn1_fused":
                plain = lambda: plain_fn(qp, kp)  # noqa: E731
                nq, nk = _real_rows(qp, kp)
                pairs, nbytes = nq * nk, (qp.numel() + kp.numel()) * 4 + qp.shape[0] * 8
                q, kk = -0.5 * qp[qp[:, 4] == 1, :3], kp[(kp[:, 3] == 1) & (kp[:, 4] < 1e37), :3]
                library = lambda: chunked_cdist_min(q, kk)  # noqa: E731
                extra = dict(library_is="torch.cdist + min over query chunks of at most 2^30 distances "
                                        "(a two-call yardstick; one cdist would not fit at 307,200²)")
            else:
                tq, tm = kwargs["tile_q"], kwargs["tile_m"]
                plain = lambda: plain_fn(*args, tq, tm)  # noqa: E731
                if name == "nn1_compact":
                    live = int(((args[4] & 2) != 0).sum())
                    list_bytes = 3 * 4 * args[2].shape[0]
                else:
                    live = int((args[2] != 0).sum())
                    list_bytes = args[2].numel() * 4
                pairs = live * tq * tm
                nbytes = (qp.numel() + kp.numel()) * 4 + qp.shape[0] * 8 + list_bytes
                extra = dict(live_tile_pairs=live, tiles=[tq, tm])
            extra.setdefault("library_is", "none: no PyTorch call visits only the surviving pairs")
        elif name == "project_to_rotation":
            (x,) = args
            kernel = lambda: tfm.project_to_rotation(x)  # noqa: E731
            plain = lambda: tfm.project_to_rotation_plain(x)  # noqa: E731
            n = x.numel() // 9
            pairs, nbytes = None, ROTATION_BYTES * n
            extra = dict(matrices=n, library_is="none: no single PyTorch call")
        elif name == "coalesced_gather":
            src, idx = args
            kernel = lambda: cg.coalesced_gather(src, idx)  # noqa: E731
            plain = lambda: cg.coalesced_gather_plain(src, idx)  # noqa: E731
            library = lambda: torch.index_select(src, 0, idx.clamp(0, src.shape[0] - 1))  # noqa: E731
            sizes = gather_bytes(src, idx)
            pairs, nbytes = None, sizes["bytes"]
            extra = dict({k_: v for k_, v in sizes.items() if k_ != "bytes"},
                         bound_64b_ms=sizes["bytes_64b"] / HBM_BYTES_PER_S * 1e3,
                         library_is="torch.index_select of the clamped indices (a yardstick)")
            GATHER_STREAMS[f"{path}, {sizes['rows']} of {src.shape[0]} rows of {sizes['width']}"] = (src, idx)
        else:
            raise AssertionError(f"{path}: no check for kernel {name}")
        quick = quick_pairs is not None and pairs is not None and pairs >= quick_pairs
        k_out = kernel()
        torch.cuda.synchronize()
        t_plain = time.perf_counter()
        p_out = plain()
        torch.cuda.synchronize()
        plain_once_ms = (time.perf_counter() - t_plain) * 1e3
        if quick:
            library = None
            extra["library_is"] = "not timed here: phase 31 times the yardstick at this shape"
        if isinstance(k_out, torch.Tensor):
            k_out, p_out = (k_out,), (p_out,)
        assert_same_bits(f"{name} ({path})", k_out, p_out)
        if pairs is None:
            by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            by_ops = ROTATION_OPS * n / F32_OPS_PER_S * 1e3 if name == "project_to_rotation" else 0.0
            bound_ms, bound_by = max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"
        else:
            bound_ms, bound_by = nn1_bound(pairs, nbytes)
        entry = dict(
            name=name, route="cuda", source=KERNEL_SOURCES[name], replaces=REPLACES[name],
            launches=launches[name], max_abs_err=max(max_abs_err(a, b) for a, b in zip(k_out, p_out)),
            ms=device_ms(kernel), plain_ms=plain_once_ms if quick else host_ms(plain), bound_ms=bound_ms,
            bound_by=bound_by,
            library_ms=None if library is None else once_ms(library, 3) if name == "nn1_fused" else device_ms(library),
            pairs=pairs, bytes=nbytes,
        )
        emit(phase=phase, path=path, tolerance="bit-exact",
             plain_timer="host clock, the compared run" if quick else "host clock, median of 3", **entry, **extra)
        out[name] = entry
    return out


def warp_stage_split(tw, graph, src_t, dst_t, tf_ref):
    """Phase 23b: the solve's outer iterations rebuilt from the port's
    stages, each ended with a synchronise and bracketed by CUDA events: nn
    search (warp, pruned 1-NN, target gathers), assembly (linearisation,
    rhs, normal matrix), Cholesky (``cholesky_ex`` + ``cholesky_solve``)
    and increment (rotations, re-projection, node motion). It must give the
    entry point's transforms bit for bit. Returns the per-stage sums and the
    last iteration's correspondences."""
    from cilantro_tpu_torch.correspondence.search import find_nn_correspondences
    from cilantro_tpu_torch.neighbors.fused_nn import maybe_make_nn1_prune_plan

    dev = src_t.device
    mcd = WARP_KW["max_corr_dist_sq"]
    sv = torch.ones(src_t.shape[0], dtype=torch.bool, device=dev)
    plan = maybe_make_nn1_prune_plan(dst_t, mcd, src_t, query_valid=sv)
    node_tf = tw.identity_warp(graph.num_nodes, 3, device=dev)
    names = ("nn_search", "assembly", "cholesky", "increment")
    dev_ms = {k: 0.0 for k in names}
    host = {k: 0.0 for k in names}
    iterations = 0
    while iterations < WARP_KW["max_iterations"]:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        stamps = []
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        ev[0].record()
        warped = tw._warp_points(graph, node_tf, src_t)
        corr = find_nn_correspondences(warped, dst_t, query_valid=sv, max_distance=mcd, prune_plan=plan)
        dgt = dst_t[torch.where(corr.mask, corr.dst_idx, 0).long()]
        w = corr.mask.to(torch.float32)
        for stage in range(4):
            if stage == 1:
                t = tw._linearize(graph, node_tf, src_t, dgt, None, w * WARP_KW["point_weight"],
                                  w * WARP_KW["plane_weight"], stiffness=WARP_KW["stiffness"],
                                  huber_delta=1e-2, affine=False)
                rhs = t.rhs()
                h = tw._normal_matrix(t, 1e-6)
            elif stage == 2:
                delta = tw._direct_solve(h, rhs)
            elif stage == 3:
                new_tf, _ = tw._apply_increment(node_tf, delta, graph.node_valid, False)
                upd = tw.node_motion(new_tf, node_tf, graph.node_valid)
            ev[stage + 1].record()
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        for i, k in enumerate(names):
            dev_ms[k] += ev[i].elapsed_time(ev[i + 1])
            host[k] += (stamps[i + 1] - stamps[i]) * 1e3
        node_tf = new_tf
        iterations += 1
        if not bool(upd >= WARP_KW.get("convergence_tol", 2.5e-3)):
            break
    if not (torch.equal(node_tf.linear, tf_ref.linear) and torch.equal(node_tf.translation, tf_ref.translation)):
        raise AssertionError("the stage split did not reproduce icp_warp_field's transforms")
    return {"device_ms": dev_ms, "host_ms": host, "iterations": iterations}, (node_tf, dgt, w)


def warp_single_path(card):
    """Phase 23: ``icp_warp_field`` at the full width (the bench's EDG row)
    on the card. Returns the graph, clouds and the launches and kernel
    entries of the path."""
    from cilantro_tpu_torch.registration import warp_field as tw

    dev = torch.device("cuda")
    src, dst, dsts = warp_inputs()
    src_t, dst_t = torch.as_tensor(src, device=dev), torch.as_tensor(dst, device=dev)
    disp = float(np.median(np.linalg.norm(dst - src, axis=1)))
    disp_n = normal_displacement(src, dst)

    nodes, node_valid = warp_control_nodes(src_t)
    live = int(node_valid.sum())
    nodes_ms = best_host_ms(lambda: warp_control_nodes(src_t))

    def build():
        return tw.build_deformation_graph(src_t, nodes, node_valid=node_valid, k_anchors=4, k_arcs=8,
                                          device=dev)

    build()
    reset_all_counts()
    kept_graph = {}
    with last_kernel_calls(kept_graph):
        graph = build()
    torch.cuda.synchronize()
    graph_launches = all_counts()
    m = graph.num_nodes
    n = src.shape[0]
    if not (m <= WARP_MAX_NODES and tw.use_direct_solver("auto", m, n, 4, 3, False)
            and tw.direct_route(graph, n, 3, False) == "sorted"):
        raise AssertionError(f"{live} nodes (capacity {m}): solver='auto' would not take the sorted direct route")
    graph_ms = dict(host_ms=best_host_ms(build), events_ms=once_ms(build))

    def solve():
        return tw.icp_warp_field(graph, src_t, dst_t, max_cg_iterations=WARP_MAX_CG, device=dev, **WARP_KW)

    solve()
    reset_all_counts()
    kept_solve = {}
    with last_kernel_calls(kept_solve):
        tf, it, conv = solve()
    torch.cuda.synchronize()
    solve_launches = all_counts()
    iterations = int(it)
    nn_passes = solve_launches["nn1_compact"] + solve_launches["nn1_masked"]
    if solve_launches["project_to_rotation"] != iterations or nn_passes != iterations:
        raise AssertionError(f"warp solve launched {solve_launches} in {iterations} outer iterations")
    tf2, it2, _ = solve()
    same_bits = int(it2) == iterations and torch.equal(tf.linear, tf2.linear) and torch.equal(
        tf.translation, tf2.translation)
    if not same_bits:
        raise AssertionError("two direct solves on the card gave different bits")
    solve_ms = dict(host_ms=best_host_ms(solve), events_ms=once_ms(solve))
    warped = tw.warp_points(graph, tf, src_t, device=dev).cpu().numpy()
    err = warp_errors(warped, dst, src)
    if not (np.isfinite(warped).all() and err["normal_median_m"] < 0.25 * disp_n):
        raise AssertionError(f"warp median normal error {err['normal_median_m']} m against a {disp_n} m "
                             "normal displacement")
    split, (tf_split, dgt, w) = warp_stage_split(tw, graph, src_t, dst_t, tf)
    # One direct GN step at the solved field, as the solve's last one ran.
    no_host_sync("warp direct GN step, 120,000 points", lambda: tw.estimate_warp_field(
        graph, src_t, dgt, None, w, init=tf_split, point_weight=WARP_KW["point_weight"],
        plane_weight=WARP_KW["plane_weight"], stiffness=WARP_KW["stiffness"], max_gn_iterations=1,
        gn_tol=0.0, solver="direct", device=dev))
    try:
        prof = profile_once(solve, solve_ms["host_ms"])
    except Exception as e:  # informational: report and go on
        prof = {"device_busy": "not measured", "error": f"{type(e).__name__}: {e}"}
    emit(phase="warp_single_path", entry="icp_warp_field", points=n, nodes=live, node_capacity=m,
         pair_segments=graph.pair_uniq_count, solver="direct (sorted narrow-input assembly)",
         outer_iterations=iterations, converged=bool(conv), median_displacement_m=disp,
         median_normal_displacement_m=disp_n, error=err,
         error_bound="normal_median_m < 0.25 x median_normal_displacement_m", error_bound_m=0.25 * disp_n, control_nodes_host_ms=nodes_ms, graph_build=graph_ms,
         solve=solve_ms, graph_launches={k: v for k, v in graph_launches.items() if v},
         solve_launches={k: v for k, v in solve_launches.items() if v}, two_runs_same_bits=same_bits,
         stage_split=split, profile=prof, card=card)
    entries = warp_kernel_checks(kept_graph, graph_launches, "phase 23, graph build")
    entries.update(warp_kernel_checks(kept_solve, solve_launches, "phase 23, solve (last outer iteration)"))
    return (graph, src, dst, dsts, src_t, nodes, node_valid, tf), graph_launches, solve_launches, entries


def warp_batched_path(tw, graph, src, dsts, src_t, card):
    """Phase 24: ``icp_warp_field_batched`` with the 8 targets on phase 23's
    graph: ms a solve amortised, outer iterations, each stream's error
    (phase 23's bound) and its warped points against a single direct solve
    of that stream with the batch's outer iterations (1e-4 m median, 1e-3 m
    max)."""
    from cilantro_tpu_torch.registration import warp_field_batched as twb

    dev = src_t.device
    dstb = torch.as_tensor(dsts, device=dev)

    def solve():
        return twb.icp_warp_field_batched(graph, src_t, dstb, device=dev, **WARP_KW)

    solve()
    reset_all_counts()
    tfb, it, conv = solve()
    torch.cuda.synchronize()
    launches = all_counts()
    host = best_host_ms(solve)
    w = torch.ones((src.shape[0], len(dsts)), device=dev)
    no_host_sync("warp batched direct GN step, B = 8", lambda: twb.estimate_warp_field_batched(
        graph, src_t, dstb.permute(1, 0, 2), None, w, init=tfb, point_weight=WARP_KW["point_weight"],
        plane_weight=WARP_KW["plane_weight"], stiffness=WARP_KW["stiffness"], device=dev))
    wb = twb.warp_points_batched(graph, tfb, src_t, device=dev).cpu().numpy()
    streams = []
    for b in range(len(dsts)):
        disp = normal_displacement(src, dsts[b])
        err = warp_errors(wb[:, b], dsts[b], src)
        # The streams iterate in lockstep: the single solve runs as many
        # outer iterations as the batch did.
        tf_s, _, _ = tw.icp_warp_field(graph, src_t, dstb[b], solver="direct", max_cg_iterations=WARP_MAX_CG,
                                       device=dev, **dict(WARP_KW, max_iterations=int(it), convergence_tol=0.0))
        diff = np.linalg.norm(tw.warp_points(graph, tf_s, src_t, device=dev).cpu().numpy() - wb[:, b], axis=1)
        streams.append(dict(error=err, median_normal_displacement_m=disp,
                            vs_single_median_m=float(np.median(diff)), vs_single_max_m=float(diff.max())))
        if not (np.isfinite(wb[:, b]).all() and err["normal_median_m"] < 0.25 * disp):
            raise AssertionError(f"batched stream {b}: median normal error {err['normal_median_m']} m, "
                                 f"normal displacement {disp} m")
        if not (np.median(diff) < 1e-4 and diff.max() < 1e-3):
            raise AssertionError(f"batched stream {b} is {np.median(diff)} / {diff.max()} m from its single solve")
    try:
        prof = profile_once(solve, host)
    except Exception as e:  # informational: report and go on
        prof = {"device_busy": "not measured", "error": f"{type(e).__name__}: {e}"}
    emit(phase="warp_batched_path", entry="icp_warp_field_batched", streams=len(dsts),
         outer_iterations=int(it), converged=conv.cpu().tolist(), host_ms=host,
         ms_per_solve_amortised=host / len(dsts), events_ms=once_ms(solve), per_stream=streams,
         launches={k: v for k, v in launches.items() if v}, profile=prof, card=card)
    return launches


@contextlib.contextmanager
def cg_counts_recorded(tw, counts: list):
    """``icp_warp_field``'s GN steps keep their CG iteration counts."""
    from unittest import mock

    real = tw.estimate_warp_field

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        counts.append(out[2])
        return out

    with mock.patch.object(tw, "estimate_warp_field", recording):
        yield counts


def warp_depth_frame():
    """The patch seen from 0.6 m above (160×120, the phase 9 intrinsics):
    the height field of :func:`warp_inputs` at each pixel's footprint."""
    from cilantro_tpu_torch.core.rgbd import CameraIntrinsics

    k = CameraIntrinsics.make(131.25, 131.25, 79.5, 59.5)
    h, w, z0 = 120, 160, 0.6
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    x, y = (u - k.cx) / k.fx * z0, (v - k.cy) / k.fy * z0
    depth = z0 - WARP_SCALE * 0.2 * np.sin(1.5 * x / WARP_SCALE) * np.cos(1.5 * y / WARP_SCALE)
    return depth.astype(np.float32), k, h, w


def warp_other_routes(tw, src, dst, nodes, node_valid, card):
    """Phase 25: the CG solver (block-Jacobi), the dense graph with CG and
    the projective variant on the card and on the CPU (the plain versions),
    at 20,000 points (every 6th of phase 23's) and its grid; the depth
    frame of :func:`warp_depth_frame` for the projective one; the dense
    field one outer iteration. Each graph is built
    on the card and copied to the CPU. Card and CPU warped points within
    1e-4 m (median) and 1e-3 m (max), the same outer iterations."""
    from cilantro_tpu_torch.core.rgbd import depth_to_points_normals

    dev = torch.device("cuda")
    src20, dst20 = src[::WARP_EVERY].copy(), dst[::WARP_EVERY].copy()
    src20_t = torch.as_tensor(src20, device=dev)
    depth, k, h, w = warp_depth_frame()
    psrc_t, _, pok_t = depth_to_points_normals(torch.as_tensor(depth, device=dev), k)
    psrc, pok = psrc_t.cpu().numpy(), pok_t.cpu().numpy()
    pdst = warp_bend(psrc)
    pnodes, pvalid = warp_control_nodes(psrc_t, pok_t)
    kw = dict(WARP_KW, max_cg_iterations=WARP_MAX_CG)
    # The dense field (20,000 nodes) is ill-conditioned: CG stops at its cap
    # of 200 in every outer iteration, and from the second on the two runs'
    # correspondences part at float32 noise that the unconverged CG
    # amplifies (the CPU at 8 threads against 1: 0.3 mm median, 4 mm max
    # after 10 outer iterations; 8e-8 m and 6.5e-6 m after one). So card and
    # CPU are held on one outer iteration of 200 CG iterations.
    dense_kw = dict(kw, max_iterations=1)
    cases = (
        ("cg", lambda d: tw.build_deformation_graph(src20_t, nodes, node_valid=node_valid, k_anchors=4,
                                                    k_arcs=8, device=d),
         lambda g, d: tw.icp_warp_field(g, src20, dst20, solver="cg", device=d, **kw), src20, dst20),
        ("dense_cg", lambda d: tw.build_dense_graph(src20_t, k_arcs=8, device=d),
         lambda g, d: tw.icp_warp_field(g, src20, dst20, solver="cg", device=d, **dense_kw), src20, dst20),
        ("projective", lambda d: tw.build_deformation_graph(psrc_t, pnodes, node_valid=pvalid, k_anchors=4,
                                                            k_arcs=8, device=d),
         lambda g, d: tw.icp_warp_field_projective(g, psrc, pdst, k, height=h, width=w, src_valid=pok,
                                                   dst_valid=pok, device=d, **kw), psrc, pdst),
    )
    launches = {}
    for label, build, run, s, t in cases:
        kept = {}
        reset_all_counts()
        with last_kernel_calls(kept):
            graph = build(dev)
        torch.cuda.synchronize()
        graph_launches = all_counts()
        reset_all_counts()
        cg_card, cg_cpu = [], []
        t0 = time.perf_counter()
        with cg_counts_recorded(tw, cg_card), last_kernel_calls(kept):
            tf_card, it_card, _ = run(graph, dev)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        solve_launches = all_counts()
        cpu_graph = graph.to("cpu")
        t0 = time.perf_counter()
        with cg_counts_recorded(tw, cg_cpu):
            tf_cpu, it_cpu, _ = run(cpu_graph, "cpu")
        cpu_s = time.perf_counter() - t0
        got = tw.warp_points(graph, tf_card, s, device=dev).cpu().numpy()
        want = tw.warp_points(cpu_graph, tf_cpu, s, device="cpu").numpy()
        diff = np.linalg.norm(got - want, axis=1)
        ok = pok if label == "projective" else np.ones(len(s), bool)
        rec = dict(points=int(len(s)), nodes=int(graph.node_valid.sum()), node_capacity=graph.num_nodes,
                   solver="cg" if label != "projective" else
                   ("direct" if tw.use_direct_solver("auto", graph.num_nodes, len(s), 4, 3, False) else "cg"),
                   outer_iterations_card=int(it_card), outer_iterations_cpu=int(it_cpu),
                   cg_iterations_card=[int(c) for c in cg_card], cg_iterations_cpu=[int(c) for c in cg_cpu],
                   card_vs_cpu_median_m=float(np.median(diff)), card_vs_cpu_max_m=float(diff.max()),
                   error=warp_errors(got[ok], t[ok]), card_s=card_s, cpu_s=cpu_s,
                   graph_launches={k_: v for k_, v in graph_launches.items() if v},
                   solve_launches={k_: v for k_, v in solve_launches.items() if v})
        emit(phase="warp_other_route", route=label, tolerance="1e-4 m median, 1e-3 m max", card=card, **rec)
        if int(it_card) != int(it_cpu) or not (np.median(diff) < 1e-4 and diff.max() < 1e-3):
            raise AssertionError(f"warp {label}: card and CPU disagree: {rec}")
        if label == "projective" and solve_launches["coalesced_gather"] != int(it_card):
            raise AssertionError(f"projective warp launched {solve_launches['coalesced_gather']} gathers "
                                 f"in {int(it_card)} outer iterations")
        launches[label] = {"graph": graph_launches, "solve": solve_launches}
        both = {k_: graph_launches[k_] + solve_launches[k_] for k_ in graph_launches}
        warp_kernel_checks(kept, both, f"phase 25, {label}")
    return launches


# ---------------------------------------------------------------------------
# The SLAM backend (phases 26-27).
# ---------------------------------------------------------------------------

# The JAX bench's SLAM row (bench.py:1035-1083): 48 frames of a 320x240
# drifting panorama sweep, keyframes every 5 frames, the scanned front end.
SLAM_H, SLAM_W, SLAM_FRAMES = 240, 320, 48
SLAM_KW = dict(keyframe_every=5, loop_min_separation=3, loop_edge_weight=5.0)
SLAM_STAGES = ("_fusion_scanned", "detect_loop_closures", "_refine_ba", "integrate_sequence")
# The JAX package's ATE after / before the backend at this row with BA
# (tests/torch_slam_witness.py, CPU), which breaks tests/test_slam_loop.py's
# 1.2 bound, and how far the port's ratio may lie from it: the card's
# front end and association part from the CPU's in the last bits.
SLAM_JAX_BA_ATE_RATIO, SLAM_ATE_RATIO_TOL = 1.2487801443717221, 0.03
# tests/test_slam_backend.py:133's mapping-scale BA: K, L, O.
BA_K, BA_L, BA_O = 64, 100_000, 300_000


def slam_intrinsics(h, w):
    """The bench's Kinect-like field of view at ``w × h``."""
    from cilantro_tpu_torch.core.rgbd import CameraIntrinsics

    return CameraIntrinsics.make(fx=w * 525.0 / 640.0, fy=w * 525.0 / 640.0, cx=(w - 1) / 2.0,
                                 cy=(h - 1) / 2.0)


def rot_err_deg(p, g) -> float:
    rel = p[:3, :3].T @ g[:3, :3]
    return float(np.degrees(np.arccos(np.clip((np.trace(rel) - 1) / 2, -1, 1))))


@contextlib.contextmanager
def slam_stage_launches(out: dict):
    """A context in which each stage of ``run_slam`` that launches kernels
    (the scanned front end, the loop closures, the pose graph, the BA and
    the map rebuild) adds the launches it made to ``out[stage]``."""
    from unittest import mock

    from cilantro_tpu_torch.slam import keyframes, slam as tslam_mod

    def counted(name, real):
        def wrapper(*args, **kwargs):
            before = all_counts()
            try:
                return real(*args, **kwargs)
            finally:
                after = all_counts()
                out[name] = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        return wrapper

    with contextlib.ExitStack() as stack:
        for name in SLAM_STAGES:
            stack.enter_context(mock.patch.object(tslam_mod, name, counted(name, getattr(tslam_mod, name))))
        stack.enter_context(mock.patch.object(
            keyframes.KeyframeGraph, "optimize", counted("pose_graph", keyframes.KeyframeGraph.optimize)))
        yield out


def slam_path(card):
    """Phase 26: ``run_slam`` at the JAX bench's SLAM row, once without and
    once with the landmark BA. Returns each configuration's launches by
    stage and the kernel entries of the path."""
    from cilantro_tpu_torch import slam as tslam

    k = slam_intrinsics(SLAM_H, SLAM_W)
    t0 = time.perf_counter()
    depths, gt = tslam.synthetic_panorama_sequence(SLAM_FRAMES, SLAM_H, SLAM_W, k, seed=3, depth_noise=0.008)
    emit(phase="slam_input", frames=SLAM_FRAMES, height=SLAM_H, width=SLAM_W, render_s=time.perf_counter() - t0)
    fcfg = tslam.FusionConfig(localize_stride=1, icp_iterations=8)
    paths, entries = [], {}
    for run_ba in (False, True):
        scfg = tslam.SlamConfig(run_ba=run_ba, **SLAM_KW)

        def run(stats=None):
            return tslam.run_slam(depths, k, map_capacity=8 * SLAM_H * SLAM_W, cfg=fcfg, slam=scfg,
                                  frontend="scanned", device="cuda", stats=stats)

        reset_all_counts()
        kept, stages, stats = {}, {}, {}
        t0 = time.perf_counter()
        with last_kernel_calls(kept), slam_stage_launches(stages):
            fmap, res = run(stats)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = all_counts()
        timed = {}
        t0 = time.perf_counter()
        run(timed)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof = "run_ba=True's covers every stage"
        if run_ba:
            try:
                prof = profile_once(run, wall_ms)
            except Exception as e:  # informational: report and go on
                prof = {"device_busy": "not measured", "error": f"{type(e).__name__}: {e}"}
        odo, ref = res.odometry_poses, res.refined_poses
        yaw = [max(rot_err_deg(p, g) for p, g in zip(poses, gt)) for poses in (odo, ref)]
        end = [rot_err_deg(poses[-1], gt[-1]) for poses in (odo, ref)]
        ate = [tslam.ate_rmse(poses, gt, device="cuda") for poses in (odo, ref)]
        pts = fmap.points[fmap.valid].cpu().numpy()
        on_wall = float((np.abs(np.linalg.norm(pts[:, [0, 2]], axis=1) - 2.5) < 0.7).mean())
        fe = stats["frontend"]
        emit(phase="slam_path", entry="run_slam", frontend="scanned", run_ba=run_ba,
             keyframes=len(res.keyframe_indices), loop_closures=res.num_loop_closures,
             max_orientation_error_deg={"before": yaw[0], "after": yaw[1]},
             endpoint_orientation_error_deg={"before": end[0], "after": end[1]},
             ate_m={"before": ate[0], "after": ate[1]}, ate_ratio=ate[1] / ate[0], map_points=len(pts), on_wall_share=on_wall,
             pose_graph_update=res.pose_graph_update,
             stage_host_ms={n: v * 1e3 for n, v in timed["stage_seconds"].items()},
             first_run_stage_host_ms={n: v * 1e3 for n, v in stats["stage_seconds"].items()},
             first_run_s=first_s, wall_ms=wall_ms,
             frontend_device_ms_per_frame=fe["device_seconds_per_frame"] * 1e3,
             frontend_launches_per_replay=fe["launches_per_frame"], stage_launches=stages,
             profile=prof, card=card)
        ate_ok = (abs(ate[1] / ate[0] - SLAM_JAX_BA_ATE_RATIO) <= SLAM_ATE_RATIO_TOL if run_ba
                  else ate[1] <= 1.2 * ate[0])
        ok = (res.num_loop_closures >= 1 and yaw[0] > 1.0 and yaw[1] < 0.65 * yaw[0]
              and end[1] < 0.65 * end[0] and len(pts) > SLAM_H * SLAM_W and on_wall > 0.95
              and np.isfinite(pts).all() and ate_ok)
        if not ok:
            raise AssertionError(f"run_slam (run_ba={run_ba}): loops {res.num_loop_closures}, max "
                                 f"orientation error {yaw} deg, endpoint {end} deg, ATE {ate} m, "
                                 f"{len(pts)} points, {on_wall} on the wall")
        label = f"run_slam(run_ba={run_ba})"
        paths += [{"phase": 26, "path": f"{label}: {stage}", "launches": launches_}
                  for stage, launches_ in stages.items()]
        paths.append({"phase": 26, "path": f"{label}: front end, launches a replay (x {SLAM_FRAMES - 1})",
                      "launches": fe["launches_per_frame"]})
        entries.update(warp_kernel_checks(kept, launches, f"phase 26, {label}", phase="slam_kernel_vs_plain"))
    return paths, entries


def inverse_route_check(card):
    """The batched inverses of the BA on the card: ``torch.linalg.inv_ex``
    on 100,000 random SPD 3×3 matrices (H_ll's shape at mapping scale) and
    64 6×6 ones, with its status, the largest |A·A⁻¹ − I|, device ms and no
    host sync."""
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for n, d in ((BA_L, 3), (BA_K, 6)):
        a = torch.randn((n, d, d), device="cuda", generator=g)
        a = a @ a.transpose(-1, -2) + 0.1 * torch.eye(d, device="cuda")
        inv, info = torch.linalg.inv_ex(a)
        resid = float((a @ inv - torch.eye(d, device="cuda")).abs().max())
        if int(info.abs().max()) != 0 or not resid < 1e-2:
            raise AssertionError(f"inv_ex on {n} {d}x{d} matrices: status {int(info.abs().max())}, "
                                 f"residual {resid}")
        no_host_sync(f"torch.linalg.inv_ex, {n} {d}x{d}", lambda: torch.linalg.inv_ex(a))
        out[f"{n}x{d}x{d}"] = dict(route="torch.linalg.inv_ex", status=0, max_residual=resid,
                                   ms=device_ms(lambda: torch.linalg.inv_ex(a)))
    emit(phase="slam_inverse_route", card=card, **out)
    return out


def slam_ba_mapping(card):
    """Phase 27: ``bundle_adjust`` at mapping scale (K = 64, L = 100,000,
    O = 300,000, seed 0; the JAX test's max_iterations=3, max_cg=30), both
    PCG forms, two runs with the same bits, a step with no host sync; then
    the pose graph and the BA card against CPU on small problems. Returns
    the launches and the kernel entries of the path."""
    from cilantro_tpu_torch import interop
    from cilantro_tpu_torch.slam import bundle_adjustment as tba
    from cilantro_tpu_torch.tools import pcg_forms
    from cilantro_tpu_torch.tools.slam_problems import mapping_ba_problem

    dev = torch.device("cuda")
    inv = inverse_route_check(card)
    problem = mapping_ba_problem(BA_K, BA_L, BA_O)
    args = interop.ba_problem_from_numpy(*problem, device=dev)
    poses, lmks, cam, lmk, obs = args
    seg = tba._Segments.of(cam, lmk, BA_K, BA_L)
    w = torch.ones(BA_O, device=dev)
    before = float(tba._ba_blocks(poses, lmks, cam, lmk, obs, w, seg)[5])

    def solve(max_cg=30, stats=None):
        return tba.bundle_adjust(*args, max_iterations=3, max_cg=max_cg, device=dev, stats=stats)

    forms = {}
    for max_cg in (30, 60):
        results = []
        for form, reads in (("no host read", contextlib.nullcontext), ("a host read an iteration",
                                                                       lambda: pcg_forms.reads_every(1))):
            with reads():
                stats = {}
                results.append(solve(max_cg, stats))
                forms[f"max_cg={max_cg}, {form}"] = dict(
                    host_ms=best_host_ms(lambda: solve(max_cg)), events_ms=once_ms(lambda: solve(max_cg)),
                    outer_iterations=stats["iterations"], cg_iterations=stats["cg_iterations"])
        a, b = results
        if not all(torch.equal(x, y) for x, y in ((a[0].linear, b[0].linear), (a[1], b[1]), (a[2], b[2]))):
            raise AssertionError(f"max_cg={max_cg}: the two PCG forms gave different bits")
    reset_all_counts()
    kept, stats = {}, {}
    with last_kernel_calls(kept):
        p1, l1, r1 = solve(stats=stats)
    torch.cuda.synchronize()
    launches = all_counts()
    p2, l2, r2 = solve()
    same_bits = all(torch.equal(x, y) for x, y in (
        (p1.linear, p2.linear), (p1.translation, p2.translation), (l1, l2), (r1, r2)))
    after = float(r1)
    if not same_bits:
        raise AssertionError("two mapping-scale BA solves on the card gave different bits")
    if not (np.isfinite(after) and after < before):
        raise AssertionError(f"BA residual {before} -> {after}: did not fall")
    fixed = torch.zeros(BA_K, dtype=torch.bool, device=dev)
    fixed[0] = True
    step_args = (poses, lmks, cam, lmk, obs, w, seg, fixed, 1.0 - fixed.float(), 1e-6, 30)
    no_host_sync("bundle_adjust step at mapping scale", lambda: tba._ba_step(*step_args))
    host = best_host_ms(solve)
    try:
        prof = profile_once(solve, host)
    except Exception as e:  # informational: report and go on
        prof = {"device_busy": "not measured", "error": f"{type(e).__name__}: {e}"}
    emit(phase="slam_ba_mapping", entry="bundle_adjust", cameras=BA_K, landmarks=BA_L, observations=BA_O,
         max_iterations=3, max_cg=30, residual_before=before, residual_after=after,
         outer_iterations=stats["iterations"], cg_iterations=stats["cg_iterations"], host_ms=host,
         events_ms=once_ms(solve), pcg_forms=forms, inverse_route=inv, two_runs_same_bits=same_bits,
         launches={k_: v for k_, v in launches.items() if v}, profile=prof, card=card)
    slam_small_card_vs_cpu(tba)
    entries = warp_kernel_checks(kept, launches, "phase 27, bundle_adjust at mapping scale",
                                 phase="slam_kernel_vs_plain")
    return launches, entries


def slam_small_card_vs_cpu(tba):
    """Phase 27b: ``optimize_pose_graph`` on :func:`pose_graph_chain` (a
    consistent graph, so both converge to its exact optimum) and
    ``bundle_adjust`` on :func:`small_ba_problem`, card against CPU within
    1e-4 (float32 sums in other orders)."""
    from cilantro_tpu_torch import interop
    from cilantro_tpu_torch.slam import pose_graph as tpg
    from cilantro_tpu_torch.tools.slam_problems import pose_graph_chain, small_ba_problem

    rng = np.random.default_rng(0)
    _, init, ei, ej, z = pose_graph_chain(rng)
    init, z = np.stack(init).astype(np.float32), np.stack(z).astype(np.float32)
    problem, _ = small_ba_problem(rng)

    def pose_graph(dev):
        p, _ = tpg.optimize_pose_graph(
            interop.transform_from_numpy(init[:, :3, :3], init[:, :3, 3], device=dev),
            torch.as_tensor(ei, device=dev), torch.as_tensor(ej, device=dev),
            interop.transform_from_numpy(z[:, :3, :3], z[:, :3, 3], device=dev), max_iterations=20)
        return torch.cat([p.linear.reshape(-1), p.translation.reshape(-1)]).cpu().numpy()

    def ba(dev):
        p, lm, r = tba.bundle_adjust(*interop.ba_problem_from_numpy(*problem, device=dev),
                                     max_iterations=15, device=dev)
        return torch.cat([p.linear.reshape(-1), p.translation.reshape(-1), lm.reshape(-1)]).cpu().numpy()

    diffs = {}
    for name, fn in (("optimize_pose_graph", pose_graph), ("bundle_adjust", ba)):
        card, cpu = fn(torch.device("cuda")), fn(torch.device("cpu"))
        diffs[name] = float(np.abs(card - cpu).max())
        if not (np.isfinite(card).all() and diffs[name] < 1e-4):
            raise AssertionError(f"{name}: card and CPU differ by {diffs[name]}")
    emit(phase="slam_card_vs_cpu", tolerance=1e-4, max_abs_diff=diffs)


# ---------------------------------------------------------------------------
# Multi-stream and pipelined fusion (phases 28-29).
# ---------------------------------------------------------------------------

BATCH_STREAMS, BATCH_FRAMES = 8, 12  # the JAX bench's multi-stream row (bench.py:440-478)


@contextlib.contextmanager
def gather_sites_recorded(kept: dict):
    """A context in which each gather of the batched step keeps the
    arguments of its last call by site: the model rows (``batched_fusion``),
    the inverse-gather update (``fusion.apply_pool_update``), the ICP
    targets (``projective``)."""
    from unittest import mock

    from cilantro_tpu_torch.core import coalesced as cg
    from cilantro_tpu_torch.correspondence import projective
    from cilantro_tpu_torch.slam import batched_fusion, fusion

    def recorder(site):
        def recording(src, idx):
            kept[site] = (src, idx)
            return cg.coalesced_gather(src, idx)
        return recording

    with mock.patch.object(batched_fusion, "coalesced_gather", recorder("integrate_rows")), \
            mock.patch.object(fusion, "coalesced_gather", recorder("inverse_gather_update")), \
            mock.patch.object(projective, "coalesced_gather", recorder("icp_projective")):
        yield kept


def batched_eager_pass(stacks, k, sites: dict, rotation: dict):
    """The B-stream driver's steps run eagerly on the card from the same
    seeded pools under ``torch.cuda.set_sync_debug_mode("error")`` (no step
    may wait on the host), recording each gather site's and the rotation
    kernel's last call: ``(pools, poses (B, F, 4, 4))``."""
    from cilantro_tpu_torch.core.rgbd import depth_to_points_normals
    from cilantro_tpu_torch.core.transforms import identity
    from cilantro_tpu_torch.slam import batched_fusion as bf
    from cilantro_tpu_torch.slam import fusion

    d = torch.as_tensor(stacks, device="cuda")
    bsz = d.shape[0]
    p, n, v = depth_to_points_normals(d[:, 0], k)
    data = bf.stack_maps([fusion.init_map_from_frame(POOL_CAPACITY, p[b], n[b], None, v[b])
                          for b in range(bsz)])
    poses = identity(3, batch_shape=(bsz,), device="cuda")
    _, packed = bf.batched_seed_localize_target(data, poses, k, H, W)
    mats = [poses.matrix()]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with gather_sites_recorded(sites), rotation_recorded(rotation):
            for f in range(1, d.shape[1]):
                p, n, v = depth_to_points_normals(d[:, f], k)
                data, poses, _, _, packed = bf.batched_fusion_step(
                    data, p, n, None, v, poses, k, packed, height=H, width=W, cfg=pool_config())
                mats.append(poses.matrix())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    emit(phase="no_host_sync", step=f"batched fusion step, B = {bsz}, {d.shape[1] - 1} steps")
    return data, torch.stack(mats, 1).cpu().numpy()


def batched_path(card):
    """Phase 28: ``run_batched_fusion_sequences`` at the JAX bench's
    multi-stream row, uncut. Returns the ``batched_paths`` entries and the
    row-4 and rotation entries of the path."""
    from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
    from cilantro_tpu_torch.slam import batched_fusion as bf
    from cilantro_tpu_torch.slam.driver import _fusion_scanned, ate_rmse, synthetic_sequence

    k = CameraIntrinsics.kinect_640()
    cfg = pool_config()
    t_phase = t0 = time.perf_counter()
    seqs = [synthetic_sequence(BATCH_FRAMES, H, W, k, seed=100 + b) for b in range(BATCH_STREAMS)]
    stacks = np.stack([np.stack(d) for d, _ in seqs])
    emit(phase="batched_input", streams=BATCH_STREAMS, frames=BATCH_FRAMES, height=H, width=W,
         render_s=time.perf_counter() - t0)

    reset_all_counts()
    stats = {}
    data, met = bf.run_batched_fusion_sequences(stacks, k, map_capacity=POOL_CAPACITY, cfg=cfg,
                                                device="cuda", stats=stats)
    torch.cuda.synchronize()
    counted = {name: v for name, v in all_counts().items() if v}
    per_step = stats["launches_per_step"]
    if any(per_step.get(name, 0) == 0 for name in ("coalesced_gather", "project_to_rotation")):
        raise AssertionError(f"batched path: a kernel of the path never launched: {per_step}")
    ates = [ate_rmse(list(met.poses[b]), seqs[b][1], device="cuda") for b in range(BATCH_STREAMS)]
    if not max(ates) < 2e-4:
        raise AssertionError(f"batched path: stream ATEs {ates}, bound 2e-4 m")
    live = data[data[..., 10] > 0.5]
    if not (min(met.num_map_points) > 0.9 * H * W and bool(torch.isfinite(live[:, 0:6]).all())):
        raise AssertionError(f"batched pools hold {met.num_map_points} live points or non-finite values")

    # Each stream against the single-stream scanned driver on it.
    diffs, single_launches = [], None
    for b in range(BATCH_STREAMS):
        single = {}
        _, sm = _fusion_scanned(list(stacks[b]), k, POOL_CAPACITY, cfg, torch.device("cuda"), single, 1)
        diffs.append(float(np.abs(np.stack(sm.poses) - met.poses[b]).max()))
        single_launches = single_launches or single["launches_per_frame"]
    if not max(diffs) <= 1e-4:
        raise AssertionError(f"batched path: streams {diffs} from their single-stream runs, bound 1e-4")

    # Launches a replay: B = 1 against B = 8 and the single-stream replay.
    one = {}
    _, met_one = bf.run_batched_fusion_sequences(stacks[:1], k, map_capacity=POOL_CAPACITY, cfg=cfg,
                                                 device="cuda", stats=one)
    if not (per_step == one["launches_per_step"] == single_launches):
        raise AssertionError(f"launches a replay: B = 8 {per_step}, B = 1 {one['launches_per_step']}, "
                             f"single stream {single_launches}")

    # The same steps eagerly: the replay's bits, and each kernel's last call.
    sites, rotation = {}, {}
    e_data, e_poses = batched_eager_pass(stacks, k, sites, rotation)
    replay_equals_eager = bool(np.array_equal(e_poses, met.poses)) and torch.equal(
        e_data.view(torch.int32), data.view(torch.int32))
    if not replay_equals_eager:
        raise AssertionError("batched path: the replay and the eager steps differ")
    entries = {}
    for site in ("integrate_rows", "inverse_gather_update", "icp_projective"):
        entries[site] = warp_kernel_checks(
            {"coalesced_gather": (sites[site], {})}, {"coalesced_gather": per_step["coalesced_gather"]},
            f"phase 28, batched {site}, last step", phase="batched_kernel_vs_plain",
        )["coalesced_gather"]
    entries["rotation"] = warp_kernel_checks(
        {"project_to_rotation": ((rotation["project_to_rotation"],), {})},
        {"project_to_rotation": per_step["project_to_rotation"]},
        "phase 28, batched ICP, last iteration", phase="batched_kernel_vs_plain",
    )["project_to_rotation"]

    steps = BATCH_FRAMES - 1
    try:
        busy = profile_once(
            lambda: bf.run_batched_fusion_sequences(stacks, k, map_capacity=POOL_CAPACITY, cfg=cfg,
                                                    device="cuda"),
            met.seconds_per_step * 1e3, runs=4 * steps + 1)
    except Exception as e:  # informational: report and go on
        busy = {"device_busy": "not measured", "error": f"{type(e).__name__}: {e}"}
    emit(
        phase="batched_path", entry="run_batched_fusion_sequences", streams=BATCH_STREAMS,
        frames=BATCH_FRAMES, map_capacity=POOL_CAPACITY, localize_stride=2,
        host_ms_per_step=met.seconds_per_step * 1e3, device_ms_per_step=stats["device_seconds_per_step"] * 1e3,
        aggregate_fps=met.aggregate_fps, aggregate_fps_device=BATCH_STREAMS / stats["device_seconds_per_step"],
        host_ms_per_step_b1=met_one.seconds_per_step * 1e3,
        device_ms_per_step_b1=one["device_seconds_per_step"] * 1e3,
        ate_m=ates, max_pose_diff_vs_single_stream=diffs, icp_iterations=stats["icp_iterations"].tolist(),
        map_points=met.num_map_points.tolist(), launches_per_replay=per_step,
        launches_per_replay_b1=one["launches_per_step"], launches_single_stream_replay=single_launches,
        launches_counted=counted, replay_equals_eager_steps=replay_equals_eager, profile=busy,
        phase_s=time.perf_counter() - t_phase, card=card,
    )
    paths = [
        {"phase": 28, "path": f"run_batched_fusion_sequences, B = {BATCH_STREAMS}, launches a replay "
                              f"(x {steps} a run)", "launches": per_step},
        {"phase": 28, "path": "the same, counted (seed target, warm-up step and capture)",
         "launches": counted},
        {"phase": 28, "path": "B = 1, launches a replay", "launches": one["launches_per_step"]},
        {"phase": 28, "path": "run_fusion_sequence_scanned, one stream, launches a replay",
         "launches": single_launches},
        {"phase": 28, "path": "every gather site and the rotation kernel held bit for bit",
         "held_bit_exact": sorted(entries)},
    ]
    return paths, entries


def pipelined_path(depths, k, card):
    """Phase 29: ``run_fusion_sequence_pipelined`` on phase 22's frames and
    configuration against ``run_fusion_sequence_scanned``: the same poses,
    iterations and pool bit for bit; host and device ms a frame of both in
    alternating turns (pipelined, scanned, scanned, pipelined)."""
    from cilantro_tpu_torch.slam.driver import run_fusion_sequence_scanned
    from cilantro_tpu_torch.slam.pipeline import run_fusion_sequence_pipelined

    t_phase = time.perf_counter()
    drivers = {"pipelined": run_fusion_sequence_pipelined, "scanned": run_fusion_sequence_scanned}
    host, device, out = {n: [] for n in drivers}, {n: [] for n in drivers}, {}
    for name in ("pipelined", "scanned", "scanned", "pipelined"):
        stats = {}
        reset_all_counts()
        fmap, met = drivers[name](depths, k, map_capacity=POOL_CAPACITY, cfg=pool_config(),
                                  device="cuda", stats=stats)
        host[name].append(met.seconds_per_frame * 1e3)
        device[name].append(stats["device_seconds_per_frame"] * 1e3)
        out[name] = (fmap, met, stats["launches_per_frame"])
    (fp, mp, lp), (fs, ms, ls) = out["pipelined"], out["scanned"]
    same = (np.array_equal(np.stack(mp.poses), np.stack(ms.poses)) and mp.icp_iterations == ms.icp_iterations
            and torch.equal(fp.data.view(torch.int32), fs.data.view(torch.int32)))
    if not same:
        raise AssertionError("pipelined and scanned drivers differ in poses, iterations or pool")
    emit(phase="pipelined_path", entry="run_fusion_sequence_pipelined", frames=FRAMES,
         map_capacity=POOL_CAPACITY, localize_stride=2, order=["pipelined", "scanned", "scanned", "pipelined"],
         host_ms_per_frame=host, device_ms_per_frame=device, bit_identical_to_scanned=True,
         icp_iterations=mp.icp_iterations, launches_per_replay=lp, launches_per_replay_scanned=ls,
         phase_s=time.perf_counter() - t_phase, card=card)
    return [{"phase": 29, "path": f"run_fusion_sequence_pipelined, {FRAMES} frames, launches a replay "
                                  f"(x {FRAMES - 1} a run)", "launches": lp}]


# ---------------------------------------------------------------------------
# Estimation and clustering (phases 30-32).
# ---------------------------------------------------------------------------

EST_HYPOTHESES, EST_PLANE_GATE, EST_TF_GATE = 1024, 0.01, 0.02  # bench.py:220-252
EST_TF_POINTS, EST_KMEANS_K = 20_000, 16
PLANTED_NORMAL = (0.2, -0.3, 0.9)  # the planted plane n·x + d = 0 (n normalised)
PLANTED_OFFSET, PLANTED_NOISE, PLANTED_SHARE = -0.4, 0.003, 0.6
MEAN_SHIFT_RADIUS, MEAN_SHIFT_CAP = 0.02, 16
BLOB_POINTS, BLOB_K, BLOB_SIGMA2, BLOB_FILTER = 10_000, 12, 2.0, 16  # tests/test_spatial_utils.py:334
BIDIR_GATE = 0.02 ** 2  # a 2 cm gate, squared: the pruned route
SMALL_POINTS, SMALL_HYPOTHESES = 8_000, 128
# The kernel wrappers of the estimation paths: the chip-wide list and the
# estimators' rotation kernel, which transform_estimation imports by name.
ESTIMATION_WRAPPERS = KERNEL_WRAPPERS + (
    ("project_to_rotation", "cilantro_tpu_torch.registration.transform_estimation", "project_to_rotation"),
)
ESTIMATION_KERNELS = ("nn1_fused", "nn1_masked", "nn1_compact", "knn_full", "knn_compact", "project_to_rotation")


def profile_info(fn, times) -> dict:
    """``profile_once`` of one run of ``fn`` beside its host ms;
    informational: a failed profile is reported, not raised."""
    try:
        return profile_once(fn, times["host_ms"])
    except Exception as e:  # informational: report and go on
        return {"device_busy": "not measured", "error": f"{type(e).__name__}: {e}"}


def timed(fn, reps=3) -> dict:
    """Host ms (best of ``reps`` after a warm-up, each ended by a
    synchronise) and the median ms between CUDA events around ``reps`` runs
    of ``fn``: wall time, since the estimators' host loops read back (the
    profile's ``device_busy`` is the device's share)."""
    return {"host_ms": best_host_ms(fn, reps), "event_wall_ms": once_ms(fn, reps), "reps": reps}


def estimation_cloud(dev):
    """The 120,000-point stand-in for the bench's ``p1`` (phase 23's height
    field, a 0.72 m patch)."""
    return torch.as_tensor(warp_inputs()[0], device=dev)


def planted_plane(n, seed=1):
    """``n`` points, ``PLANTED_SHARE`` of them on the planted plane with
    ``PLANTED_NOISE`` m of normal noise, the rest uniform in a 2 m cube."""
    rng = np.random.default_rng(seed)
    normal = np.asarray(PLANTED_NORMAL) / np.linalg.norm(PLANTED_NORMAL)
    u = np.cross(normal, [1.0, 0.0, 0.0])
    u /= np.linalg.norm(u)
    v = np.cross(normal, u)
    m = int(PLANTED_SHARE * n)
    ab = rng.uniform(-1, 1, (m, 2))
    on = -PLANTED_OFFSET * normal + ab[:, :1] * u + ab[:, 1:] * v + rng.normal(0, PLANTED_NOISE, (m, 1)) * normal
    off = rng.uniform(-1, 1, (n - m, 3))
    return np.concatenate([on, off]).astype(np.float32), normal, m


def bench_transform_case(p1, n=None):
    """bench.py:228-242: the first ``n`` (20,000) points, 0.2 rad about z
    and (0.05, -0.02, 0.03), 30% of the targets replaced by uniform
    [-2, 2]³."""
    rng = np.random.default_rng(0)
    n = EST_TF_POINTS if n is None else n
    sub = np.asarray(p1[:n], np.float32)
    ang = 0.2
    rmat = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    t = np.float32([0.05, -0.02, 0.03])
    dst = sub @ rmat.T + t
    out = rng.random(n) < 0.3
    dst[out] = rng.uniform(-2, 2, (int(out.sum()), 3)).astype(np.float32)
    return sub, dst, rmat, t


def call_shape(name, args, kwargs):
    """A kernel call's key in phases 30-31: the kernel, its first input's
    shape and its ``k``."""
    return name, tuple(args[0].shape), kwargs.get("k")


def counted(fn, kept, label):
    """Run ``fn`` with every kernel count at 0 and the wrappers keeping
    the last call of each kernel at each :func:`call_shape` in
    ``kept[(label, kernel, shape, k)]``; return its result and the
    launches."""
    reset_all_counts()
    calls = {}
    with last_kernel_calls(calls, ESTIMATION_WRAPPERS, key=call_shape):
        out = fn()
        torch.cuda.synchronize()
    kept.update({(label,) + key: call for key, call in calls.items()})
    return out, {name: v for name, v in all_counts().items() if v}


def estimation_row(card):
    """Phase 30: the bench's estimation row at its size."""
    import importlib

    from cilantro_tpu_torch.core.pca import fit_pca
    from cilantro_tpu_torch.model_estimation import ransac_plane, ransac_transform

    km = importlib.import_module("cilantro_tpu_torch.clustering.kmeans")  # the package's `kmeans` is the function

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    pts = estimation_cloud(dev)
    gen = torch.Generator(device=dev)
    kept, paths = {}, []

    def plane_on(p):
        return lambda: ransac_plane(gen.manual_seed(0), p, EST_PLANE_GATE, num_hypotheses=EST_HYPOTHESES)

    label = "ransac_plane, 120,000 points, 1,024 hypotheses"
    (plane, res), launches = counted(plane_on(pts), kept, label)
    t_plane = timed(plane_on(pts))
    emit(phase="estimation_ransac_plane", points=int(pts.shape[0]), hypotheses=EST_HYPOTHESES,
         gate_m=EST_PLANE_GATE, inliers=int(res.num_inliers), normal=plane.normal.tolist(),
         offset=float(plane.offset), launches=launches, profile=profile_info(plane_on(pts), t_plane),
         **t_plane, card=card)
    paths.append({"phase": 30, "path": label, "launches": launches})

    planted, normal, m = planted_plane(pts.shape[0])
    (plane, res), _ = counted(plane_on(torch.as_tensor(planted, device=dev)), {}, "planted plane")
    got = plane.normal.cpu().numpy().astype(np.float64)
    sign = float(np.sign(got @ normal))
    angle_deg = float(np.degrees(np.arccos(min(1.0, abs(got @ normal)))))
    offset_err = abs(float(plane.offset) * sign - PLANTED_OFFSET)
    kept_share = float(res.inlier_mask[:m].float().mean())
    emit(phase="estimation_planted_plane", points=int(planted.shape[0]), planted=m, noise_m=PLANTED_NOISE,
         normal_err_deg=angle_deg, offset_err_m=offset_err, planted_inliers_kept=kept_share,
         inliers=int(res.num_inliers), card=card)
    if not (angle_deg < 0.5 and offset_err < 5e-3 and kept_share >= 0.95):
        raise AssertionError(f"planted plane: {angle_deg}° / {offset_err} m / {kept_share} kept "
                             "(bounds 0.5°, 5 mm, 95%)")

    sub, dst, rmat, t = bench_transform_case(pts.cpu().numpy())
    sub_t, dst_t = torch.as_tensor(sub, device=dev), torch.as_tensor(dst, device=dev)

    def tf_run():
        return ransac_transform(gen.manual_seed(0), sub_t, dst_t, EST_TF_GATE, num_hypotheses=EST_HYPOTHESES)

    label = "ransac_transform, 20,000 correspondences, 1,024 hypotheses"
    (tf, res), launches = counted(tf_run, kept, label)
    rot_err = rot_angle(tf.linear.cpu().numpy(), rmat)
    t_err = float(np.abs(tf.translation.cpu().numpy() - t).max())
    t_tf = timed(tf_run)
    emit(phase="estimation_ransac_transform", correspondences=EST_TF_POINTS, outliers=0.3,
         hypotheses=EST_HYPOTHESES, gate_m=EST_TF_GATE, inliers=int(res.num_inliers), rotation_err_rad=rot_err,
         translation_err_m=t_err, launches=launches, profile=profile_info(tf_run, t_tf), **t_tf, card=card)
    if not (rot_err < 1e-4 and t_err < 1e-4):
        raise AssertionError(f"ransac_transform: {rot_err} rad / {t_err} m (bounds 1e-4)")
    if not launches.get("project_to_rotation"):
        raise AssertionError(f"ransac_transform launched no rotation kernel: {launches}")
    paths.append({"phase": 30, "path": label, "launches": launches})

    def kmeans_run():
        return km.kmeans(gen.manual_seed(0), pts, EST_KMEANS_K)

    label = "kmeans, k = 16, 120,000 points"
    result, launches = counted(kmeans_run, kept, label)
    iters = int(result.iterations)
    n = int(pts.shape[0])
    t_km = timed(kmeans_run)
    flops, nbytes = 2.0 * n * EST_KMEANS_K * 3 * iters, float(n) * 3 * 4 * iters
    # The centroid update, two forms on the final labels: the one-hot GEMM
    # the module uses (as the JAX package) and a broadcast product summed
    # over the points.
    onehot = (result.labels[:, None] == torch.arange(EST_KMEANS_K, device=dev)[None, :]).float()
    forms = {"onehot_gemm": device_ms(lambda: torch.einsum("nk,nd->kd", onehot, pts)),
             "broadcast_sum": device_ms(lambda: torch.sum(onehot[:, :, None] * pts[:, None, :], dim=0))}
    emit(phase="estimation_kmeans", points=n, k=EST_KMEANS_K, init="k-means++", iterations=iters,
         converged=bool(result.converged), flops=flops, bytes=nbytes,
         gflops_per_s=flops / (t_km["host_ms"] * 1e6), gbytes_per_s=nbytes / (t_km["host_ms"] * 1e6),
         update_ms=forms, launches=launches, profile=profile_info(kmeans_run, t_km), **t_km, card=card)
    paths.append({"phase": 30, "path": label, "launches": launches})

    pca = fit_pca(pts)
    ref = np.linalg.eigh(np.cov(pts.cpu().numpy().astype(np.float64).T))[0][::-1]
    rel = float(np.max(np.abs(pca.eigenvalues.cpu().numpy() - ref) / ref))
    det = float(torch.linalg.det(pca.eigenvectors.double()))
    t_pca = timed(lambda: fit_pca(pts))
    emit(phase="estimation_pca", points=n, eigenvalues=pca.eigenvalues.tolist(), float64_eigenvalues=ref.tolist(),
         max_rel_err=rel, det=det, profile=profile_info(lambda: fit_pca(pts), t_pca), **t_pca, card=card)
    if not (rel < 1e-4 and abs(det - 1.0) < 1e-5):
        raise AssertionError(f"fit_pca: eigenvalues {rel} from float64 (bound 1e-4), det {det}")
    emit(phase="estimation_row", phase_s=time.perf_counter() - t_phase)
    return paths, kept


def blobs(n_per, k=3, sep=8.0, seed=0):
    """tests/test_spatial_utils.py's planted blobs (σ = 0.2, ``sep`` apart)."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.standard_normal((n_per, 3)) * 0.2 + sep * i for i in range(k)]).astype(np.float32)


def same_partition(a, b) -> bool:
    a, b = np.asarray(a).tolist(), np.asarray(b).tolist()
    return len(set(zip(a, b))) == len(set(a)) == len(set(b))


def clustering_path(pair, card):
    """Phase 31: the clustering chain, capped mean shift, spectral
    clustering on the kNN graph and bidirectional correspondences."""
    from cilantro_tpu_torch.clustering import (
        connected_components, edge_mask_from_evaluator, mean_shift, spectral_clustering_knn,
    )
    from cilantro_tpu_torch.correspondence.search import find_nn_correspondences_bidirectional
    from cilantro_tpu_torch.neighbors import knn_search

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    pts = estimation_cloud(dev)
    kept, paths = {}, []

    def chain():
        nb = knn_search(pts, pts, 8, exclude_self=True)
        return connected_components(nb, edge_mask=edge_mask_from_evaluator(nb, pts, max_distance=0.02),
                                    min_size=100)

    def record(name, label, run, extra, reps=3):
        out, launches = counted(run, kept, label)
        times = timed(run, reps)
        busy = profile_info(run, times)
        emit(phase=f"clustering_{name}", launches=launches, profile=busy, **times, **extra(out), card=card)
        paths.append({"phase": 31, "path": label, "launches": launches})
        return out, launches

    _, launches = record("components", "knn_search(k=8) + edge mask + connected_components, 120,000 points",
                         chain, lambda cc: dict(points=int(pts.shape[0]), components=int(cc.num_components),
                                                largest=int(cc.sizes[0])))
    if not launches.get("knn_compact"):
        raise AssertionError(f"the components chain launched no compact kNN kernel: {launches}")

    _, launches = record(
        "mean_shift", f"mean_shift(max_neighbors={MEAN_SHIFT_CAP}), 120,000 points",
        lambda: mean_shift(pts, MEAN_SHIFT_RADIUS, max_neighbors=MEAN_SHIFT_CAP),
        lambda r: dict(radius_m=MEAN_SHIFT_RADIUS, iterations=int(r.iterations), clusters=int(r.num_clusters),
                       overflowed=bool(r.overflowed)), reps=1)
    if not launches.get("knn_compact"):
        raise AssertionError(f"capped mean shift launched no compact kNN kernel: {launches}")

    blob_pts = torch.as_tensor(blobs(BLOB_POINTS), device=dev)

    def spectral():
        nb = knn_search(blob_pts, blob_pts, BLOB_K, exclude_self=True)
        w = torch.where(nb.mask, torch.exp(-nb.distances / BLOB_SIGMA2), 0.0)
        gen = torch.Generator(device=dev).manual_seed(0)
        return spectral_clustering_knn(gen, nb.indices, w, nb.mask, 3, filter_degree=BLOB_FILTER)

    res, _ = record("spectral", f"spectral_clustering_knn, 3 x {BLOB_POINTS:,} points, k = {BLOB_K}", spectral,
                    lambda r: dict(points=3 * BLOB_POINTS, eigenvalues=r.eigenvalues.tolist(),
                                   clusters=len(set(r.labels.tolist()))), reps=1)
    truth = np.repeat(np.arange(3), BLOB_POINTS)
    if not same_partition(res.labels.cpu().numpy(), truth):
        raise AssertionError("spectral_clustering_knn did not recover the three blobs exactly")

    (sp, _, sv), (dp, _, dv) = pair
    for label, gate in (("fused route, no gate", None), ("pruned route, 2 cm gate", BIDIR_GATE)):
        corr, launches = record(
            "bidirectional" if gate is None else "bidirectional_gated",
            f"find_nn_correspondences_bidirectional, 640x480 frames 1 -> 0, {label}",
            lambda gate=gate: find_nn_correspondences_bidirectional(sp, dp, src_valid=sv, dst_valid=dv,
                                                                    max_distance=gate),
            lambda c: dict(correspondences=int(c.count()), src_valid=int(sv.sum())))
        if not any(launches.get(k) for k in ("nn1_fused", "nn1_masked", "nn1_compact")):
            raise AssertionError(f"bidirectional search ({label}) launched no nn1 kernel: {launches}")
    emit(phase="clustering_path", phase_s=time.perf_counter() - t_phase)
    return paths, kept


def estimation_card_vs_cpu(card):
    """Phase 32: the same entry points on the CPU (plain versions) at
    smaller sizes, on draws made once on the card."""
    import importlib

    from cilantro_tpu_torch.clustering import connected_components, edge_mask_from_evaluator
    from cilantro_tpu_torch.core.pca import fit_pca
    from cilantro_tpu_torch.model_estimation import ransac as rs
    from cilantro_tpu_torch.neighbors import knn_search

    km = importlib.import_module("cilantro_tpu_torch.clustering.kmeans")

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    pts = estimation_cloud(dev)[:: WARP_POINTS // SMALL_POINTS][:SMALL_POINTS].contiguous()
    n = int(pts.shape[0])
    planted = torch.as_tensor(planted_plane(n)[0], device=dev)
    sub, dst, _, _ = bench_transform_case(warp_inputs()[0], SMALL_POINTS)
    gen = torch.Generator(device=dev).manual_seed(3)
    scores = torch.rand((SMALL_HYPOTHESES, n), generator=gen, device=dev)
    gumbel = km._gumbel_from_uniform(torch.rand((EST_KMEANS_K, n), generator=gen, device=dev))
    sides, launches = {}, {}
    for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
        def on(x, where=where):
            return torch.as_tensor(x).to(where)

        def run(on=on):
            plane = rs._ransac_plane_from_scores(on(scores), on(planted), EST_PLANE_GATE)
            tf = rs._ransac_transform_from_scores(on(scores), on(sub), on(dst), EST_TF_GATE)
            kmr = km._kmeans_from_draws(on(gumbel), on(pts), EST_KMEANS_K)
            nb = knn_search(on(pts), on(pts), 8, exclude_self=True)
            cc = connected_components(nb, edge_mask=edge_mask_from_evaluator(nb, on(pts), max_distance=0.02))
            return plane, tf, kmr, cc, fit_pca(on(pts))

        if side == "card":
            sides[side], launches = counted(run, {}, "card vs CPU")
        else:
            sides[side] = run()
    (pg, tg_, kg, cg_, ag), (pc, tc_, kc, cc_, ac) = sides["card"], sides["cpu"]
    tol = 1e-3 * n
    checks = {}
    for name, (g, c) in (("plane", (pg[1], pc[1])), ("transform", (tg_[1], tc_[1]))):
        hg, hc = g.hypothesis_inliers.cpu(), c.hypothesis_inliers
        checks[name] = dict(best_card=int(torch.argmax(hg)), best_cpu=int(torch.argmax(hc)),
                            max_count_diff=int((hg - hc).abs().max()),
                            inliers_card=int(g.num_inliers), inliers_cpu=int(c.num_inliers))
        c_ = checks[name]
        if not (c_["best_card"] == c_["best_cpu"] and c_["max_count_diff"] <= tol
                and abs(c_["inliers_card"] - c_["inliers_cpu"]) <= tol):
            raise AssertionError(f"card vs CPU {name}: {c_} (within {tol} points)")
    lab_same = float((kg.labels.cpu() == kc.labels).float().mean())
    cen_diff = float((kg.centroids.cpu() - kc.centroids).abs().max())
    checks["kmeans"] = dict(iterations_card=int(kg.iterations), iterations_cpu=int(kc.iterations),
                            max_centroid_diff=cen_diff, labels_equal=lab_same)
    if not (int(kg.iterations) == int(kc.iterations) and cen_diff <= 1e-4 and lab_same >= 0.999):
        raise AssertionError(f"card vs CPU k-means: {checks['kmeans']}")
    gl, cl = cg_.labels.cpu().numpy(), cc_.labels.numpy()
    pairs = {}
    for a, b in zip(gl.tolist(), cl.tolist()):
        pairs[(a, b)] = pairs.get((a, b), 0) + 1
    best = {}
    for (a, b), c in pairs.items():  # each card label's most common CPU label
        best[a] = max(best.get(a, (0, None)), (c, b))
    renamed_same = sum(c for c, _ in best.values()) / len(gl)
    checks["components"] = dict(count_card=int(cg_.num_components), count_cpu=int(cc_.num_components),
                                labels_equal_after_renaming=renamed_same)
    if not (int(cg_.num_components) == int(cc_.num_components) and renamed_same >= 0.999):
        raise AssertionError(f"card vs CPU components: {checks['components']}")
    pca_diff = max(float((ag.eigenvalues.cpu() - ac.eigenvalues).abs().max()),
                   float((ag.mean.cpu() - ac.mean).abs().max()),
                   float((ag.eigenvectors.cpu().abs() - ac.eigenvectors.abs()).abs().max()))
    checks["pca"] = dict(max_diff=pca_diff)
    if not pca_diff <= 1e-5:
        raise AssertionError(f"card vs CPU PCA: {pca_diff} (bound 1e-5)")
    emit(phase="estimation_card_vs_cpu", points=n, hypotheses=SMALL_HYPOTHESES, launches=launches,
         phase_s=time.perf_counter() - t_phase, card=card, **checks)
    return [{"phase": 32, "path": f"card side of the card-vs-CPU run, {n:,} points", "launches": launches}]


def estimation_paths(pair, card):
    """Phases 30-32 and each kernel of phases 30-31 held bit for bit against
    its plain version on the inputs of its last call on each path at each
    input shape (:func:`call_shape`), timed beside its bound (the warp's
    checks)."""
    paths, kept = estimation_row(card)
    more, kept_31 = clustering_path(pair, card)
    paths += more
    kept.update(kept_31)
    path_launches = {p["path"]: p["launches"] for p in paths}
    launches, held = {}, []
    for p in paths:
        for name, v in p["launches"].items():
            launches[name] = launches.get(name, 0) + v
    for (label, name, shape, k), call in kept.items():
        where = f"{label}: last call at input shape {list(shape)}" + ("" if k is None else f", k = {k}")
        entries = warp_kernel_checks({name: call}, path_launches[label], where,
                                     phase="estimation_kernel_vs_plain")
        held += [dict(kernel=name, path=label, input_shape=list(shape), k=k,
                      **{f: e[f] for f in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms")}) for e in entries.values()]
    paths += estimation_card_vs_cpu(card)
    paths.append({"phase": "30-31", "path": "every kernel of phases 30-31, held bit for bit on its last call on "
                                            "each path at each input shape",
                  "launches": {k: v for k, v in launches.items() if k in ESTIMATION_KERNELS},
                  "held_bit_exact": held})
    return paths, held


# ---------------------------------------------------------------------------
# Slice G2: PLY files, the host codec, the live viewer, renders and timers.
# ---------------------------------------------------------------------------


def ply_frame_clouds(depths, k, dev):
    """Frames 0 and 1 as compacted clouds on the card: points and normals
    from the depth image, colours the ``jet`` colormap of the depth (the
    port's colormap on the card)."""
    from cilantro_tpu_torch.core.containers import PointCloud, compact
    from cilantro_tpu_torch.core.rgbd import depth_to_points_normals
    from cilantro_tpu_torch.utils import colormap

    out = []
    for depth in depths[:2]:
        d = torch.as_tensor(depth, device=dev)
        pts, nrm, valid = depth_to_points_normals(d, k)
        out.append(compact(PointCloud(points=pts, normals=nrm, colors=colormap(d.reshape(-1)), valid=valid)))
    return out


def same_bits(a, b) -> bool:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def register_pair(icp_mod, src, dst):
    """Phase 15's registration of ``src`` onto ``dst``: ``dst``'s normals
    from ``with_normals_knn(k=12)``, then ``icp_multires`` with the bench
    levels."""
    dst_n = dst.with_normals_knn(KNN_K)
    res = icp_mod.icp_multires(
        src.points, dst_n.points, dst_normals=dst_n.normals, src_valid=src.valid, dst_valid=dst_n.valid,
        metric="combined", convergence_tol=1e-4, levels=BENCH_LEVELS,
    )
    return dst_n, res


def ply_path(depths, k, rel, card):
    """Phase 33: frames 0 and 1 written to PLY (binary and ASCII) and read
    back by the C++ codec (called directly, so a codec that does not build
    fails the run) and by the Python parser; the binary pair loaded onto the
    card by ``PointCloud.from_ply`` and registered as phase 15 does, normals
    and pose bit for bit those of the in-memory clouds; the kernels of that
    run held bit for bit on their last calls."""
    import tempfile

    from cilantro_tpu_torch import native
    from cilantro_tpu_torch.core.containers import PointCloud
    from cilantro_tpu_torch.registration import icp as icp_mod
    from cilantro_tpu_torch.utils.ply_io import _read_point_cloud_python

    t0 = time.perf_counter()
    compiled = native.build_host()
    build_s = time.perf_counter() - t0
    clouds = ply_frame_clouds(depths, k, torch.device("cuda"))
    host = [tuple(a.cpu().numpy() for a in (c.points, c.normals, c.colors)) for c in clouds]
    u8 = [np.clip(h[2] * 255.0 + 0.5, 0, 255).astype(np.uint8) for h in host]
    rec = dict(phase="ply_path", points=[int(c.capacity) for c in clouds], g_plus_plus_build_s=build_s,
               compiled=sorted(compiled), card=card)
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for fmt, binary in (("binary", True), ("ascii", False)):
            paths[fmt] = [os.path.join(tmp, f"frame{i}_{fmt}.ply") for i in (0, 1)]
            for c, p in zip(clouds, paths[fmt]):
                c.to_ply(p, binary=binary)
            rec[f"{fmt}_bytes"] = [os.path.getsize(p) for p in paths[fmt]]
            rec[f"{fmt}_write_ms"] = host_ms(lambda: clouds[0].to_ply(paths[fmt][0], binary=binary))
            for reader, read in (("native", native.ply_read_native), ("python", _read_point_cloud_python)):
                for i, p in enumerate(paths[fmt]):
                    pts, nrm, col = read(p)
                    if not (same_bits(pts, host[i][0]) and same_bits(nrm, host[i][1])):
                        raise AssertionError(f"{reader} reader: frame {i}'s {fmt} file gave other points or normals")
                    if not np.array_equal(np.clip(col * 255.0 + 0.5, 0, 255).astype(np.uint8), u8[i]):
                        raise AssertionError(f"{reader} reader: frame {i}'s {fmt} file gave other 8-bit colours")
                rec[f"{fmt}_read_{reader}_ms"] = host_ms(lambda: read(paths[fmt][0]))
        nat, py = native.ply_read_native(paths["binary"][0]), _read_point_cloud_python(paths["binary"][0])
        rec["binary_readers_same_points_normals"] = same_bits(nat[0], py[0]) and same_bits(nat[1], py[1])
        rec["binary_readers_colour_max_diff"] = float(np.abs(nat[2] - py[2]).max())
        if not rec["binary_readers_same_points_normals"]:
            raise AssertionError("the two readers gave other bits for one binary file")
        loaded = [PointCloud.from_ply(p) for p in paths["binary"]]
    if not all(c.points.device.type == "cuda" for c in loaded):
        raise AssertionError("from_ply did not land on the card")
    want_n, want = register_pair(icp_mod, clouds[1], clouds[0])
    reset_all_counts()
    kept = {}
    t0 = time.perf_counter()
    with last_kernel_calls(kept):
        got_n, got = register_pair(icp_mod, loaded[1], loaded[0])
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {name: v for name, v in all_counts().items() if v}
    same = (torch.equal(got_n.normals.view(torch.int32), want_n.normals.view(torch.int32))
            and torch.equal(got_n.valid, want_n.valid)
            and torch.equal(got.transform.linear.view(torch.int32), want.transform.linear.view(torch.int32))
            and torch.equal(got.transform.translation.view(torch.int32),
                            want.transform.translation.view(torch.int32))
            and int(got.iterations) == int(want.iterations))
    dt, dr = gt_error(got.transform.linear, got.transform.translation, rel)
    rec.update(launches=launches, register_ms=ms, same_bits_as_in_memory=same, iterations=int(got.iterations),
               translation_error_m=dt, rotation_error_rad=dr)
    emit(**rec)
    if not same:
        raise AssertionError("normals or pose from the PLY-loaded pair differ from the in-memory pair's")
    if not (launches.get("knn_compact") and launches.get("nn1_compact")):
        raise AssertionError(f"the PLY-loaded registration did not run both compact kernels: {launches}")
    if not (dt < 5e-4 and dr < 1e-4):
        raise AssertionError(f"PLY-loaded registration off by {dt} m / {dr} rad")
    held = warp_kernel_checks(kept, launches, "PLY-loaded pair: with_normals_knn + icp_multires",
                              phase="g2_kernel_vs_plain")
    return {"phase": 33, "path": "PLY-loaded pair: with_normals_knn(k=12) + icp_multires",
            "launches": launches, "held_bit_exact": sorted(held)}


def scene_points(html: str, name: str) -> np.ndarray:
    """The positions of the points object ``name`` in a page's scene."""
    import base64
    import re

    scene = json.loads(re.search(r"const SCENE = (\{.*?\});\n", html, re.S).group(1))
    obj = next(p for p in scene["objects"] if p["name"] == name and p["kind"] == "points")
    return np.frombuffer(base64.b64decode(obj["pos"]), np.float32).reshape(-1, 3)


def graph_loops(fn, args, lo, hi):
    """``fn(*args)`` run ``lo`` and ``hi`` times, each loop captured in a
    CUDA graph; the two replays (``op_time``'s ``precompiled`` pair)."""
    from cilantro_tpu_torch.utils.honest_timing import _looped

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)  # warm-up off the capturing stream
    torch.cuda.current_stream().wait_stream(side)
    graphs = []
    for iters in (lo, hi):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            _looped(fn, iters)(*args)
        graphs.append(g)
    return tuple(lambda *a, g=g: g.replay() for g in graphs)


def viz_path(depths, k, streams, card):
    """Phase 34: the pool host-loop driver on 6 frames with a
    ``LiveMapViewer(every=2)`` hook (each snapshot's scene holds the map's
    valid points, subsampled as ``live.py`` does); the gather held bit for
    bit on its last call there; ``render_cloud_image`` of the final map on
    the card against the CPU; ``op_time`` of the integrate-stream gather
    beside the CUDA-event median, and its roofline line."""
    import tempfile

    from cilantro_tpu_torch.core import coalesced as cg
    from cilantro_tpu_torch.core.containers import PointCloud
    from cilantro_tpu_torch.slam.driver import run_fusion_sequence
    from cilantro_tpu_torch.utils.honest_timing import op_time
    from cilantro_tpu_torch.utils.roofline import roofline
    from cilantro_tpu_torch.viz import LiveMapViewer, render_cloud_image

    frames = 6
    snaps = []
    with tempfile.TemporaryDirectory() as tmp:
        page = os.path.join(tmp, "live.html")
        viewer = LiveMapViewer(page, every=2)

        def hook(fi, fmap, pose):
            t0 = time.perf_counter()
            viewer(fi, fmap, pose)
            ms = (time.perf_counter() - t0) * 1e3
            if fi % viewer.every == 0:
                live = fmap.points[fmap.valid]
                step = max(len(live) // viewer.subsample, 1) if len(live) > viewer.subsample else 1
                with open(page) as f:
                    html = f.read()
                snaps.append(dict(frame=fi, ms=ms, map_points=int(live.shape[0]), page_bytes=len(html),
                                  same=same_bits(scene_points(html, "map"), live[::step].cpu().numpy())))

        reset_all_counts()
        kept = {}
        with last_kernel_calls(kept):
            fmap, met = run_fusion_sequence(depths[:frames], k, map_capacity=POOL_CAPACITY, cfg=pool_config(),
                                            on_frame=hook, device="cuda")
            torch.cuda.synchronize()
    launches = {name: v for name, v in all_counts().items() if v}
    if [s["frame"] for s in snaps] != [2, 4] or not all(s["same"] for s in snaps):
        raise AssertionError(f"live snapshots {snaps}")
    if not launches.get("coalesced_gather"):
        raise AssertionError(f"the pool run with the viewer launched no gather: {launches}")
    held = warp_kernel_checks(kept, launches, "run_fusion_sequence, 6 frames, LiveMapViewer(every=2)",
                              phase="g2_kernel_vs_plain")
    cloud = PointCloud(points=fmap.points, normals=fmap.normals, valid=fmap.valid)
    img = render_cloud_image(cloud, color_by="normal")
    img_cpu = render_cloud_image(cloud, color_by="normal", device="cpu")
    bg, bg_cpu = img == 1.0, img_cpu == 1.0
    off = np.abs(img - img_cpu).max(-1) > 1e-6
    render = dict(height=480, width=640, drawn_pixels=int((~bg.all(-1)).sum()),
                  background_same=bool(np.array_equal(bg, bg_cpu)), pixels_beyond_1e6=int(off.sum()),
                  share_beyond_1e6=float(off.mean()), max_abs_diff=float(np.abs(img - img_cpu).max()),
                  ms=host_ms(lambda: render_cloud_image(cloud, color_by="normal")),
                  cpu_ms=host_ms(lambda: render_cloud_image(cloud, color_by="normal", device="cpu")))
    if not render["background_same"]:
        raise AssertionError("the card's render and the CPU's differ in their background")
    src, idx = streams["integrate_rows"]
    gather = lambda s, i: cg.coalesced_gather(s, i)  # noqa: E731
    event_ms = device_ms(lambda: gather(src, idx))
    eager = op_time(gather, (src, idx))
    replayed = op_time(gather, (src, idx), precompiled=graph_loops(gather, (src, idx), 2, 8))
    sizes = gather_bytes(src, idx)
    n, nbytes = sizes["rows"], sizes["bytes"]
    line = roofline("coalesced_gather integrate stream", event_ms / 1e3, bytes_moved=nbytes, rows=n)
    timing = dict(event_median_ms=event_ms, op_time_eager=dataclasses.asdict(eager),
                  op_time_graph=dataclasses.asdict(replayed), roofline=line.strip(),
                  bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                  bound_64b_ms=sizes["bytes_64b"] / HBM_BYTES_PER_S * 1e3, **sizes)
    emit(phase="viz_path", frames=frames, launches=launches, icp_iterations=met.icp_iterations,
         snapshots=snaps, render=render, gather_timing=timing, card=card)
    print(line, file=sys.stderr, flush=True)
    if not eager.linearity > 1.3:
        raise AssertionError(f"op_time of the gather is not linear in its loop length: {eager}")
    return {"phase": 34, "path": "run_fusion_sequence, 6 frames, LiveMapViewer(every=2)", "launches": launches,
            "held_bit_exact": sorted(held)}


# ---------------------------------------------------------------------------
# The multi-device paths (phases 35-36).
# ---------------------------------------------------------------------------

# The sharded fusion module imports the gather by name.
PARALLEL_WRAPPERS = KERNEL_WRAPPERS + (
    ("coalesced_gather", "cilantro_tpu_torch.parallel.sharded_fusion", "coalesced_gather"),
)
PARALLEL_KERNELS = ("coalesced_gather", "nn1_fused", "nn1_masked", "nn1_compact", "project_to_rotation")
# tests/test_sharded_scale.py's pool-to-frame ratio at 640x480: 1,228,800
# slots (78.6 MB), 6 frames, stride-2 localize.
SHARDED_CAPACITY, SHARDED_FRAMES = 4 * H * W, 6
SHARDED_ICP_KW = dict(max_iterations=15)  # the entry points' defaults otherwise (1 cm gate)
SHARDED_ICP_BOUND = (5e-4, 1e-4)  # m, rad from the true motion: phase 6's bounds
PARALLEL_RANKS = 2
RANK_GROUP_TIMEOUT_S, RANK_WAIT_S = 180, 480
QUICK_PAIRS = 1 << 34  # nn1_fused calls past this: plain timed on the compared run


def by_site(name, args, kwargs):
    """One kept call a kernel and first input's shape: the gather's sites
    (pool rows, ICP targets) apart."""
    return (name, tuple(args[0].shape))


def counted_run(fn):
    """``fn()`` with every count at 0 before it and each kernel's last call
    at each input shape kept: ``(out, launches, kept)``."""
    reset_all_counts()
    kept = {}
    with last_kernel_calls(kept, PARALLEL_WRAPPERS, key=by_site):
        out = fn()
    torch.cuda.synchronize()
    return out, {k_: v for k_, v in all_counts().items() if v}, kept


def hold_path(label, launches, kept, held: dict, sharded_launches: dict):
    """Each kernel of a sharded path bit for bit against its plain version
    on its last call at each input shape there (:func:`warp_kernel_checks`),
    its launches added to ``sharded_launches[kernel][label]``."""
    for (name, shape), call in kept.items():
        entries = warp_kernel_checks({name: call}, launches, f"{label}: last call at input shape {list(shape)}",
                                     phase="parallel_kernel_vs_plain", quick_pairs=QUICK_PAIRS)
        for e in entries.values():
            held[f"{label} / {name} {list(shape)}"] = {
                f: e[f] for f in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    for name, n in launches.items():
        if name in PARALLEL_KERNELS:
            sharded_launches.setdefault(name, {})[label] = n


def event_ms(fn):
    """``(host ms, CUDA-event ms)`` of one run of ``fn``, each ended by a
    synchronise (the events give wall time where ``fn`` reads back)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return (time.perf_counter() - t0) * 1e3, start.elapsed_time(end), out


def tf_numpy(tf):
    return tf.linear.detach().cpu().numpy(), tf.translation.detach().cpu().numpy()


def sharded_icp_runs(mesh, pair):
    """Both sharded ICPs on phase 6's pair (frame 1 onto frame 0), this
    rank's shards cut by ``shard_cloud_arrays``: ``{label: (fn, ...)}``."""
    from cilantro_tpu_torch.parallel import shard_cloud_arrays, sharded_combined_icp, sharded_combined_icp_ring

    (sp, sn, sv), (dp, dn, dv) = pair
    src = shard_cloud_arrays(mesh, "points", sp, sv)
    dst = shard_cloud_arrays(mesh, "map", dp, dn, dv)
    ring = shard_cloud_arrays(mesh, "points", sp, sv, dp, dn, dv)
    return {
        "sharded_combined_icp": lambda: sharded_combined_icp(*src, *dst, mesh=mesh, **SHARDED_ICP_KW),
        "sharded_combined_icp_ring": lambda: sharded_combined_icp_ring(*ring, mesh=mesh, **SHARDED_ICP_KW),
    }


def sharded_fusion_frames(mesh, frames, k, timed=True):
    """Phase 35b / 36's sharded fusion: this rank's pool shard seeded from
    frame 0, then ``sharded_fusion_step`` on each later frame. Returns the
    poses, the final shard, the live rows of the whole pool, each frame's
    winner image and each frame's host / CUDA-event ms."""
    from cilantro_tpu_torch.core.transforms import identity
    from cilantro_tpu_torch.parallel import collectives as cc
    from cilantro_tpu_torch.parallel import init_sharded_map, sharded_fusion_step
    from cilantro_tpu_torch.slam.fusion import FusionConfig, _valid_col

    cfg = FusionConfig(localize_stride=2)
    p0, n0, v0 = frames[0]
    data = init_sharded_map(mesh, SHARDED_CAPACITY, p0, n0, None, v0)
    pose = identity(3, device=p0.device)
    poses, widx_all, host, events = [], [], [], []
    for p, n, v in frames[1:]:
        h_ms, e_ms, (data, pose, widx) = event_ms(lambda: sharded_fusion_step(
            data, p, n, None, v, pose, k, mesh=mesh, height=H, width=W, cfg=cfg))
        host.append(h_ms)
        events.append(e_ms)
        poses.append(pose.matrix().cpu().numpy())
        widx_all.append(widx)
    live = int(cc.psum((data[:, _valid_col(data.shape[1])] > 0.5).sum().to(torch.int64).reshape(1), mesh,
                       "map")[0])
    return poses, data, live, widx_all, host, events


def single_fusion_frames(frames, k):
    """The port's one-device ``fusion_step`` on the same frames (rendering
    in localize, as the sharded step does): poses, live rows, ms a frame."""
    from cilantro_tpu_torch.core.transforms import identity
    from cilantro_tpu_torch.slam.fusion import FusionConfig, fusion_step, init_map_from_frame

    cfg = FusionConfig(localize_stride=2)
    p0, n0, v0 = frames[0]
    fmap = init_map_from_frame(SHARDED_CAPACITY, p0, n0, None, v0)
    pose = identity(3, device=p0.device)
    poses, host, events = [], [], []
    for p, n, v in frames[1:]:
        h_ms, e_ms, (fmap, pose, _, _, _) = event_ms(lambda: fusion_step(
            fmap, p, n, None, v, pose, k, height=H, width=W, cfg=cfg))
        host.append(h_ms)
        events.append(e_ms)
        poses.append(pose.matrix().cpu().numpy())
    return poses, int(fmap.num_points()), host, events


def warp_problem(dev):
    """Phase 23's height field (120,000 points, the bend) and its 1,040-node
    graph (capacity 1,056), built on ``dev``."""
    from cilantro_tpu_torch.registration import warp_field as tw

    src, dst, _ = warp_inputs()
    src_t, dst_t = torch.as_tensor(src, device=dev), torch.as_tensor(dst, device=dev)
    nodes, node_valid = warp_control_nodes(src_t)
    graph = tw.build_deformation_graph(src_t, nodes, node_valid=node_valid, k_anchors=4, k_arcs=8, device=dev)
    return graph, src_t, dst_t


SHARDED_WARP_KW = dict(WARP_KW, max_cg_iterations=WARP_MAX_CG, solver="cg")


def sharded_ba_args(mesh):
    """Phase 27's mapping-scale problem partitioned by landmark as
    ``tests/test_slam_backend.py::test_sharded_matches`` does (the
    observations sorted by shard, local landmark ids), each shard's block
    padded to the largest with invalid observations (the landmarks are
    drawn at random, so the blocks differ in length; ``run_slam`` pads the
    same way), this rank's shards: ``(poses, landmarks, cam, local lmk,
    obs, valid)``. On one rank nothing is padded or moved."""
    from cilantro_tpu_torch import interop
    from cilantro_tpu_torch.parallel import shard_cloud_arrays
    from cilantro_tpu_torch.parallel import collectives as cc
    from cilantro_tpu_torch.tools.slam_problems import mapping_ba_problem

    r, t, lmk0, cam, lmk, obs = mapping_ba_problem(BA_K, BA_L, BA_O)
    shards = cc.axis_size(mesh, "points")
    lp = BA_L // shards
    blocks = [np.flatnonzero(lmk // lp == d) for d in range(shards)]
    width = max(len(b) for b in blocks)
    order = np.concatenate([np.concatenate([b, np.zeros(width - len(b), np.int64)]) for b in blocks])
    valid = np.concatenate([np.arange(width) < len(b) for b in blocks])
    poses = interop.transform_from_numpy(r, t, device=torch.device("cuda"))
    return (poses,) + shard_cloud_arrays(mesh, "points", lmk0, np.where(valid, cam[order], 0).astype(np.int32),
                                         np.where(valid, lmk[order] % lp, 0).astype(np.int32),
                                         np.where(valid[:, None], obs[order], 0.0).astype(np.float32), valid)


def world_one_paths(depths, gt, k, pair, rel, card):
    """Phase 35: every sharded entry point at world size 1 over NCCL on the
    card, at full width, each against its one-device counterpart, each
    kernel held bit for bit on its last call there. Returns the paths line
    entries, the held kernels, the launches by kernel and path, and the
    results phase 36 is held to."""
    import torch.distributed as dist

    from cilantro_tpu_torch import slam as tslam
    from cilantro_tpu_torch.parallel import collectives as cc
    from cilantro_tpu_torch.parallel import make_mesh, process_info, sharded_icp_warp_field
    from cilantro_tpu_torch.registration import warp_field as tw
    from cilantro_tpu_torch.slam import bundle_adjustment as tba

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    mesh = make_mesh(device="cuda")
    if dist.get_backend() != "nccl" or mesh.size() != 1:
        raise AssertionError(f"world of one: backend {dist.get_backend()}, mesh {mesh}")
    emit(phase="parallel_world_one", mesh=str(mesh), backend=dist.get_backend(),
         nccl=".".join(map(str, torch.cuda.nccl.version())), process_info=process_info(), card=card)
    paths, held, sharded_launches, ref = [], {}, {}, {}

    # 35a. Both sharded ICPs on phase 6's pair.
    for label, fn in sharded_icp_runs(mesh, pair).items():
        (tf, it), launches, kept = counted_run(fn)
        h_ms, e_ms, _ = event_ms(fn)
        lin, tr = tf_numpy(tf)
        dt, dr = gt_error(tf.linear, tf.translation, rel)
        err = {"translation_m": dt, "rotation_rad": dr}
        if not (dt < SHARDED_ICP_BOUND[0] and dr < SHARDED_ICP_BOUND[1]):
            raise AssertionError(f"{label}: {err} from the true motion")
        if not (launches.get("nn1_fused") == int(it) and launches.get("project_to_rotation") == int(it)):
            raise AssertionError(f"{label}: launches {launches} for {int(it)} iterations")
        emit(phase="parallel_icp", entry=label, world=1, backend="nccl", iterations=int(it), error=err,
             host_ms=h_ms, events_ms=e_ms, launches=launches, card=card)
        ref[label] = (lin, tr, int(it))
        hold_path(f"35 {label}", launches, kept, held, sharded_launches)
        paths.append({"phase": 35, "path": f"{label}, 640x480 pair, world 1 (NCCL)", "launches": launches})

    # 35b. Sharded fusion against the one-device step.
    frames = [frame_clouds(d, k, dev) for d in depths[:SHARDED_FRAMES]]
    (poses, data, live, widx, host, events), launches, kept = counted_run(
        lambda: sharded_fusion_frames(mesh, frames, k))
    s_poses, s_live, s_host, s_events = single_fusion_frames(frames, k)
    dpose = max(float(np.abs(a - b).max()) for a, b in zip(poses, s_poses))
    if not (dpose < 5e-5 and abs(live - s_live) <= 1e-3 * s_live):
        raise AssertionError(f"sharded fusion: poses {dpose} apart, live rows {live} vs {s_live}")
    if not (launches.get("coalesced_gather") and launches.get("project_to_rotation")):
        raise AssertionError(f"sharded fusion launches {launches}")
    coll = collective_cost(mesh)
    emit(phase="parallel_fusion", entry="sharded_fusion_step", world=1, backend="nccl", frames=SHARDED_FRAMES,
         capacity=SHARDED_CAPACITY, pool_mb=SHARDED_CAPACITY * 16 * 4 / 1e6, localize_stride=2,
         max_pose_diff_vs_fusion_step=dpose, live_rows=live, live_rows_fusion_step=s_live,
         host_ms_per_frame=host, events_ms_per_frame=events, fusion_step_host_ms_per_frame=s_host,
         fusion_step_events_ms_per_frame=s_events,
         median_host_ms={"sharded": statistics.median(host[1:]), "fusion_step": statistics.median(s_host[1:])},
         median_events_ms={"sharded": statistics.median(events[1:]),
                           "fusion_step": statistics.median(s_events[1:])},
         collectives_ms_per_frame=coll, launches=launches, card=card)
    ref["fusion"] = (poses, live)
    hold_path("35 sharded_fusion_step", launches, kept, held, sharded_launches)
    paths.append({"phase": 35, "path": f"sharded_fusion_step, {SHARDED_FRAMES} frames 640x480, world 1",
                  "launches": launches})
    del data, frames

    # 35c. The sharded warp against the one-device CG solve: at world 1
    # every sum of both is the same sorted reduction, so the two solves,
    # and two sharded runs, give the same bits.
    graph, src_t, dst_t = warp_problem(dev)
    (tf, it, _), launches, kept = counted_run(
        lambda: sharded_icp_warp_field(graph, src_t, dst_t, mesh=mesh, **SHARDED_WARP_KW))
    h_ms, e_ms, (tf2, it2, _) = event_ms(
        lambda: sharded_icp_warp_field(graph, src_t, dst_t, mesh=mesh, **SHARDED_WARP_KW))
    sh_ms, se_ms, (tf1, it1, _) = event_ms(lambda: tw.icp_warp_field(graph, src_t, dst_t, device=dev,
                                                                   **SHARDED_WARP_KW))
    warped = tw.warp_points(graph, tf, src_t, device=dev)
    diff = torch.linalg.vector_norm(warped - tw.warp_points(graph, tf1, src_t, device=dev), dim=1)
    med = float(diff.median())
    for label, (other, other_it) in (("the one-device solve", (tf1, it1)), ("a second sharded run", (tf2, it2))):
        same = int(other_it) == int(it) and all(
            torch.equal(a.view(torch.int32), b.view(torch.int32))
            for a, b in ((tf.linear, other.linear), (tf.translation, other.translation)))
        if not same:
            raise AssertionError(f"sharded warp: not the bits of {label} (warped points {med} m apart, median)")
    emit(phase="parallel_warp", entry="sharded_icp_warp_field", world=1, backend="nccl", points=WARP_POINTS,
         nodes=graph.num_nodes, solver="cg", iterations=int(it), iterations_one_device=int(it1),
         median_diff_m=med, max_diff_m=float(diff.max()), errors=warp_errors(warped.cpu().numpy(), dst_t.cpu().numpy()),
         host_ms=h_ms, events_ms=e_ms, one_device_host_ms=sh_ms, one_device_events_ms=se_ms,
         launches=launches, card=card)
    ref["warp"] = warped.cpu().numpy()
    hold_path("35 sharded_icp_warp_field", launches, kept, held, sharded_launches)
    paths.append({"phase": 35, "path": "sharded_icp_warp_field, 120,000 points, CG, world 1", "launches": launches})
    del graph

    # 35d. The landmark-sharded BA at mapping scale.
    args = sharded_ba_args(mesh)

    def solve():
        return tslam.bundle_adjust_sharded(*args, mesh=mesh, max_iterations=3, max_cg=30)

    (p1, l1, r1), launches, kept = counted_run(solve)
    h_ms, e_ms, (p2, l2, r2) = event_ms(solve)
    same = all(torch.equal(a, b) for a, b in ((p1.linear, p2.linear), (p1.translation, p2.translation),
                                              (l1, l2), (r1, r2)))
    full = (args[0], args[1], args[2], args[3], args[4])
    sh_ms, se_ms, (q, _, rq) = event_ms(lambda: tba.bundle_adjust(*full, max_iterations=3, max_cg=30,
                                                                   device=dev))
    dp = float(torch.abs(p1.linear - q.linear).max().maximum(torch.abs(p1.translation - q.translation).max()))
    if not (same and float(r1) < 3.0 and dp < 1e-4):
        raise AssertionError(f"sharded BA: same bits {same}, residual {float(r1)}, {dp} from bundle_adjust")
    emit(phase="parallel_ba", entry="bundle_adjust_sharded", world=1, backend="nccl", k=BA_K, l=BA_L, o=BA_O,
         residual=float(r1), residual_one_device=float(rq), max_pose_diff=dp, two_solves_same_bits=same,
         host_ms=h_ms, events_ms=e_ms, one_device_host_ms=sh_ms, one_device_events_ms=se_ms,
         launches=launches, card=card)
    ref["ba"] = tf_numpy(p1)
    hold_path("35 bundle_adjust_sharded", launches, kept, held, sharded_launches)
    paths.append({"phase": 35, "path": "bundle_adjust_sharded, K = 64, L = 100,000, O = 300,000, world 1",
                  "launches": launches})
    del args

    # 35e. run_slam with the BA sharded, at phase 26's row.
    sk = slam_intrinsics(SLAM_H, SLAM_W)
    sdepths, sgt = tslam.synthetic_panorama_sequence(SLAM_FRAMES, SLAM_H, SLAM_W, sk, seed=3, depth_noise=0.008)
    cfg = tslam.SlamConfig(run_ba=True, ba_mesh=mesh, **SLAM_KW)
    (fmap, res), launches, _ = counted_run(lambda: tslam.run_slam(
        sdepths, sk, map_capacity=8 * SLAM_H * SLAM_W, cfg=tslam.FusionConfig(localize_stride=1, icp_iterations=8),
        slam=cfg, frontend="scanned", device="cuda"))
    odo, refd = res.odometry_poses, res.refined_poses
    yaw = [max(rot_err_deg(p, g) for p, g in zip(ps, sgt)) for ps in (odo, refd)]
    end = [rot_err_deg(ps[-1], sgt[-1]) for ps in (odo, refd)]
    ate = [tslam.ate_rmse(ps, sgt, device="cuda") for ps in (odo, refd)]
    pts = fmap.points[fmap.valid].cpu().numpy()
    on_wall = float((np.abs(np.linalg.norm(pts[:, [0, 2]], axis=1) - 2.5) < 0.7).mean())
    ok = (res.num_loop_closures >= 1 and yaw[0] > 1.0 and yaw[1] < 0.65 * yaw[0] and end[1] < 0.65 * end[0]
          and len(pts) > SLAM_H * SLAM_W and on_wall > 0.95
          and abs(ate[1] / ate[0] - SLAM_JAX_BA_ATE_RATIO) <= SLAM_ATE_RATIO_TOL)
    emit(phase="parallel_slam", entry="run_slam", ba_mesh="world 1 (NCCL)", loop_closures=res.num_loop_closures,
         max_orientation_error_deg=yaw, endpoint_orientation_error_deg=end, ate_m=ate, ate_ratio=ate[1] / ate[0],
         map_points=len(pts), on_wall_share=on_wall, launches=launches, card=card)
    if not ok:
        raise AssertionError(f"run_slam with ba_mesh: loops {res.num_loop_closures}, {yaw}, {end}, ATE {ate}")
    paths.append({"phase": 35, "path": "run_slam(run_ba=True, ba_mesh=world 1), phase 26's row", "launches": launches})
    for name, n in launches.items():
        if name in PARALLEL_KERNELS:
            sharded_launches.setdefault(name, {})["35 run_slam(ba_mesh)"] = n
    dist.destroy_process_group()
    emit(phase="parallel_world_one_done", phase_s=time.perf_counter() - t_phase)
    return paths, held, sharded_launches, ref


def collective_cost(mesh):
    """CUDA-event ms of one frame's collectives of ``sharded_fusion_step``
    alone (4 MIN all-reduces of H·W values, 2 sums of the (H·W, 16) image)
    on ``mesh``'s ``map`` group, median of 25 after a warm-up."""
    from cilantro_tpu_torch.parallel import collectives as cc

    dev = torch.device("cuda")
    d = torch.rand(H * W, device=dev)
    i = torch.randint(0, 1 << 20, (H * W,), device=dev, dtype=torch.int32)
    img = torch.rand(H * W, 16, device=dev)

    def frame():
        for _ in range(2):
            cc.pmin(d, mesh, "map")
            cc.pmin(i, mesh, "map")
            cc.psum(img, mesh, "map")

    return device_ms(frame)


def rank_main(argv) -> int:
    """Phase 36's rank: ``python3 chip_smoke.py --rank RANK WORLD STORE OUT``.
    One of ``PARALLEL_RANKS`` gloo ranks on the one card: the sharded paths
    on its shards, results saved to ``OUT/rank<RANK>.pt``."""
    import datetime

    import torch.distributed as dist

    rank, world, store, out_dir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.cuda.set_device(0)
    timeout = datetime.timedelta(seconds=RANK_GROUP_TIMEOUT_S)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world, timeout=timeout)
    from cilantro_tpu_torch import slam as tslam
    from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
    from cilantro_tpu_torch.parallel import make_mesh, sharded_icp_warp_field
    from cilantro_tpu_torch.registration import warp_field as tw

    dev = torch.device("cuda")
    k = CameraIntrinsics.kinect_640()
    depths = np.load(os.path.join(out_dir, "depths.npy"))
    out, t0 = {"rank": rank}, time.perf_counter()
    pair = (frame_clouds(depths[1], k, dev), frame_clouds(depths[0], k, dev))
    for label, (p, q) in (("sharded_combined_icp", (1, world)), ("sharded_combined_icp_ring", (world, 1))):
        mesh = make_mesh(p, q, device="cuda", timeout=timeout)
        fn = sharded_icp_runs(mesh, pair)[label]
        fn()
        h_ms, e_ms, (tf, it) = event_ms(fn)
        out[label] = dict(zip(("linear", "translation"), tf_numpy(tf)), iterations=int(it), host_ms=h_ms,
                          events_ms=e_ms, mesh=[p, q])
    mesh = make_mesh(1, world, device="cuda", timeout=timeout)
    frames = [frame_clouds(d, k, dev) for d in depths[:SHARDED_FRAMES]]
    poses, _, live, widx, host, events = sharded_fusion_frames(mesh, frames, k)
    out["fusion"] = dict(poses=np.stack(poses), live=live, widx=widx[-1].cpu().numpy(), host_ms=host,
                         events_ms=events)
    del frames
    mesh = make_mesh(world, 1, device="cuda", timeout=timeout)
    graph, src_t, dst_t = warp_problem(dev)
    h_ms, e_ms, (tf, it, _) = event_ms(lambda: sharded_icp_warp_field(graph, src_t, dst_t, mesh=mesh,
                                                                     **SHARDED_WARP_KW))
    warped = tw.warp_points(graph, tf, src_t, device=dev)
    out["warp"] = dict(warped=warped.cpu().numpy(), iterations=int(it), host_ms=h_ms, events_ms=e_ms,
                       nonfinite_nodes=int((~torch.isfinite(tf.linear)).sum() + (~torch.isfinite(tf.translation)).sum()),
                       nonfinite_points=int((~torch.isfinite(warped)).any(dim=1).sum()))
    del graph
    args = sharded_ba_args(mesh)
    h_ms, e_ms, (p, _, r) = event_ms(lambda: tslam.bundle_adjust_sharded(*args, mesh=mesh, max_iterations=3,
                                                                        max_cg=30))
    out["ba"] = dict(zip(("linear", "translation"), tf_numpy(p)), residual=float(r), host_ms=h_ms, events_ms=e_ms)
    del args
    pipe = tslam.make_pipeline_mesh()
    stats = {}
    fmap, met = tslam.run_fusion_sequence_pipelined(list(depths), k, mesh=pipe, map_capacity=POOL_CAPACITY,
                                                    cfg=pool_config(), device="cuda", stats=stats)
    out["pipeline"] = dict(poses=np.stack(met.poses), iterations=met.icp_iterations,
                           data=fmap.data.cpu().numpy(), stage_s=stats["stage_seconds"],
                           ms_per_frame=met.seconds_per_frame * 1e3)
    out["seconds"] = time.perf_counter() - t0
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
    print(json.dumps({"rank": rank, "seconds": out["seconds"]}), flush=True)
    return 0


def two_rank_paths(depths, k, ref, card):
    """Phase 36: ``PARALLEL_RANKS`` gloo ranks on the one card, as
    subprocesses of this script, run phase 35's sharded paths on their
    shards (the same 640x480 ICP pair, 6 fusion frames, the warp, the BA;
    not ``run_slam``, whose front end every rank would repeat) and the
    two-rank pipeline on phase 10's 16 frames. Each rank's results are held
    to phase 35's within the CPU tests' tolerances, the pipeline to the
    scanned driver bit for bit, and the ranks to each other bit for bit."""
    import tempfile

    from cilantro_tpu_torch.slam.driver import run_fusion_sequence_scanned

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ranks_", dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        np.save(os.path.join(tmp, "depths.npy"), np.stack(depths).astype(np.float32))
        cmd = [sys.executable, os.path.abspath(__file__), "--rank"]
        procs = [subprocess.Popen(cmd + [str(r), str(PARALLEL_RANKS), os.path.join(tmp, "store"), tmp],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(PARALLEL_RANKS)]
        logs = []
        try:
            for p in procs:
                left = max(1.0, RANK_WAIT_S - (time.perf_counter() - t_phase))
                logs.append(p.communicate(timeout=left)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"phase 36 rank {r} exited {p.returncode}:\n{log[-3000:]}")
        res = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(PARALLEL_RANKS)]
    fs, ms = run_fusion_sequence_scanned(depths, k, map_capacity=POOL_CAPACITY, cfg=pool_config(), device="cuda")
    checks = {}
    r0 = res[0]
    for label in ("sharded_combined_icp", "sharded_combined_icp_ring"):
        lin, tr, it = ref[label]
        checks[label] = max(float(np.abs(r0[label]["linear"] - lin).max()),
                            float(np.abs(r0[label]["translation"] - tr).max()))
        if not (checks[label] < 1e-5 and r0[label]["iterations"] == it):
            raise AssertionError(f"phase 36 {label}: {checks[label]} from phase 35, {r0[label]['iterations']} "
                                 f"iterations against {it}")
    poses, live = ref["fusion"]
    checks["fusion_pose"] = float(np.abs(r0["fusion"]["poses"] - np.stack(poses)).max())
    checks["fusion_live"] = abs(r0["fusion"]["live"] - live) / live
    checks["warp_median_m"] = float(np.median(np.linalg.norm(r0["warp"]["warped"] - ref["warp"], axis=1)))
    lin, tr = ref["ba"]
    checks["ba"] = max(float(np.abs(r0["ba"]["linear"] - lin).max()), float(np.abs(r0["ba"]["translation"] - tr).max()))
    pipe_same = (np.array_equal(r0["pipeline"]["poses"], np.stack(ms.poses))
                 and r0["pipeline"]["iterations"] == ms.icp_iterations
                 and np.array_equal(r0["pipeline"]["data"], fs.data.cpu().numpy()))
    replicated = {}
    for key, fields in (("sharded_combined_icp", ("linear", "translation", "iterations")),
                        ("sharded_combined_icp_ring", ("linear", "translation", "iterations")),
                        ("fusion", ("poses", "live", "widx")), ("warp", ("warped", "iterations")),
                        ("ba", ("linear", "translation", "residual")), ("pipeline", ("poses", "iterations", "data"))):
        replicated[key] = all(np.array_equal(np.asarray(res[1][key][f]), np.asarray(r0[key][f])) for f in fields)
    emit(phase="parallel_two_ranks", ranks=PARALLEL_RANKS, backend="gloo", device="one card",
         differences_from_phase_35=checks, pipeline_bit_identical_to_scanned=pipe_same,
         warp_nonfinite=[(r["warp"]["nonfinite_nodes"], r["warp"]["nonfinite_points"]) for r in res],
         warp_iterations=[r["warp"]["iterations"] for r in res],
         replicated_identical=replicated, rank_seconds=[r["seconds"] for r in res],
         host_ms={key: [r[key]["host_ms"] for r in res] for key in
                  ("sharded_combined_icp", "sharded_combined_icp_ring", "warp", "ba")},
         events_ms={key: [r[key]["events_ms"] for r in res] for key in
                    ("sharded_combined_icp", "sharded_combined_icp_ring", "warp", "ba")},
         fusion_host_ms_per_frame=[r["fusion"]["host_ms"] for r in res],
         fusion_events_ms_per_frame=[r["fusion"]["events_ms"] for r in res],
         fusion_median_host_ms=[statistics.median(r["fusion"]["host_ms"][1:]) for r in res],
         fusion_median_events_ms=[statistics.median(r["fusion"]["events_ms"][1:]) for r in res],
         pipeline_ms_per_frame=[r["pipeline"]["ms_per_frame"] for r in res],
         pipeline_stage_s=[r["pipeline"]["stage_s"] for r in res],
         scanned_ms_per_frame=ms.seconds_per_frame * 1e3, phase_s=time.perf_counter() - t_phase, card=card)
    # Fusion on two map shards deals augments to other slots than on one
    # (z-buffer ties then go by other rows): phase 35's bounds against the
    # one-device step.
    ok = (checks["fusion_pose"] < 5e-5 and checks["fusion_live"] <= 1e-3 and checks["warp_median_m"] < 1e-4
          and checks["ba"] < 1e-4 and pipe_same and all(replicated.values()))
    if not ok:
        raise AssertionError(f"phase 36: {checks}, pipeline bit for bit {pipe_same}, replicated {replicated}")
    return [{"phase": 36, "path": f"{PARALLEL_RANKS} gloo ranks on one card: ICP (both), fusion, warp, BA, "
                                  "pipeline", "checks": checks}]



# ---------------------------------------------------------------------------
# Phase 38: the examples; phase 39: dryrun_multichip.
# ---------------------------------------------------------------------------

EXAMPLES = ("rigid_icp", "fusion", "slam", "batched_serving", "non_rigid_icp", "normals_and_downsampling",
            "kd_tree", "robust_normals", "ransac_and_clustering", "spectral_and_components", "mean_shift",
            "io_and_images", "convex_hull", "space_regions", "mds_and_pca", "image_viewer", "visualizer")
EXAMPLES_WITH_OUT = ("fusion", "io_and_images", "image_viewer", "visualizer")
# The examples whose every printed line the CPU run repeats: host hull code,
# exact set tests and exact round trips.
EXAMPLES_AS_ON_CPU = ("io_and_images", "convex_hull", "space_regions")
NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")


def printed(out: str, start: str) -> list:
    """The numbers on the one printed line that starts with ``start``."""
    found = [ln for ln in out.splitlines() if ln.startswith(start)]
    if len(found) != 1:
        raise AssertionError(f"{len(found)} printed lines start with {start!r}:\n{out}")
    return [float(x) for x in NUMBER.findall(found[0])]


def example_truth(name: str, out: str, out_dir: str) -> dict:
    """The figures of merit an example printed, each held to its planted
    truth (the bounds of ``tests/test_torch_examples_*.py``, here at the
    full-width default input); raises on the first that misses."""
    fig, ok = {}, True
    if name == "rigid_icp":
        fig["max_abs_error"] = printed(out, "max abs error:")[0]
        ok = fig["max_abs_error"] < 1e-3
    elif name == "fusion":
        frames, fig["ms_per_frame"], fig["ate_mm"], fig["map_points"] = printed(out, "12 frames,")
        ok = fig["ate_mm"] < 1.0 and fig["map_points"] > 0.9 * H * W
        ok &= all(os.path.getsize(os.path.join(out_dir, f)) > 0 for f in ("fusion_map.ply", "fusion_poses.npy"))
    elif name == "slam":
        fig["keyframes"], fig["loop_closures"] = printed(out, "keyframes:")
        fig["max_orientation_error_deg"] = printed(out, "max orientation error:")
        fig["ate_cm"] = printed(out, "ATE:")
        fig["map_points"], fig["front_end_ms_per_frame"], fig["total_s"] = printed(out, "rebuilt map:")
        ok = (fig["loop_closures"] >= 1 and fig["max_orientation_error_deg"][1] < fig["max_orientation_error_deg"][0]
              and fig["ate_cm"][1] <= fig["ate_cm"][0])
    elif name == "batched_serving":
        fig["splat_ms_per_frame"], fig["splat_fps"], fig["splat_ate_mm"], fig["live_surfels"], _ = printed(
            out, "splat fusion:")
        warp = next(ln for ln in out.splitlines() if ln.startswith("batched warp x4:"))
        fig["warp_outer_iterations"] = printed(out, "batched warp x4:")[1]
        fig["warp_median_errors_mm"] = [float(e) for e in re.findall(r"([\d.]+)mm", warp)]
        ok = (fig["splat_ate_mm"] < 2.0 and "converged [True, True, True, True]" in warp
              and len(fig["warp_median_errors_mm"]) == 4 and max(fig["warp_median_errors_mm"]) < 10.0)
    elif name == "non_rigid_icp":
        fig["control_nodes"] = int(next(ln for ln in out.splitlines() if ln.endswith("control nodes")).split()[0])
        fig["outer_iterations"] = printed(out, "done in")[1]
        fig["median_error_mm"] = printed(out, "median error")[0]
        ok = fig["median_error_mm"] < 10.0  # half the 20 mm bend
    elif name == "normals_and_downsampling":
        fig["bins_1cm"] = printed(out, "downsample @1cm:")[1]
        fig["median_abs_dot"] = printed(out, "|dot| vs the input's stored normals")[-1]
        ok = fig["median_abs_dot"] > 0.99
    elif name == "kd_tree":
        fig["mean_nn_dist_mm"] = printed(out, "kNN k=8:")[-1]
        agree, total = printed(out, "grid backend:")
        fig["grid_agrees"] = [agree, total]
        ok = agree == total
    elif name == "robust_normals":
        fig["normal_error_deg"] = printed(out, "clean-point normal error:")
        ok = fig["normal_error_deg"][1] < 2.0 and fig["normal_error_deg"][1] < fig["normal_error_deg"][0]
        ok &= "inlier query valid=True, outlier query valid=False" in out
    elif name == "ransac_and_clustering":
        n = int(out.splitlines()[0].split()[0])
        plane = printed(out, "RANSAC plane:")
        fig["plane"] = dict(normal=plane[:3], offset=plane[3], inliers=plane[4])
        fig["transform"] = printed(out, "RANSAC transform:")
        fig["components"] = printed(out, "connected components:")
        ok = (abs(plane[2]) > 0.95 and abs(plane[3]) < 0.05 and fig["transform"][0] < 1e-3
              and fig["transform"][1] < 1e-3 and fig["transform"][2] == 1500
              and fig["components"][0] == 1 and fig["components"][2] >= 0.99 * n)
    elif name == "spectral_and_components":
        fig["purity"] = [printed(out, f"spectral [{kind:12s}]")[-2]
                         for kind in ("unnormalized", "normalized", "random_walk")]
        n, segments, _, largest = printed(out, "connected components (")[:4]
        fig["components"] = dict(points=n, segments=segments, largest=largest)
        ok = all(p == 600 for p in fig["purity"]) and segments == 1 and largest >= 0.99 * n
    elif name == "mean_shift":
        fig["flat"] = printed(out, "mean shift [flat    ]")
        fig["gaussian"] = printed(out, "mean shift [gaussian]")
        fig["capped"] = printed(out, "mean shift [capped  ]")
        ok = all(f[0] == 4 and f[2] < 50 and f[3] == 1200 for f in (fig["flat"], fig["gaussian"]))
        ok &= fig["capped"][0] == 4
    elif name == "io_and_images":
        fig["matrix_max_err"] = [printed(out, f"matrix I/O ({k}):")[0] for k in ("binary", "text")]
        fig["cloud_to_depth_max_err_m"] = printed(out, "cloud→depth roundtrip:")[0]
        ok = (fig["matrix_max_err"] == [0.0, 0.0] and fig["cloud_to_depth_max_err_m"] == 0.0
              and "points exact=True, colors within 1/255=True" in out)
    elif name == "mds_and_pca":
        fig["mds"] = printed(out, "MDS:")
        fig["pca_eigenvalues"] = printed(out, "PCA eigenvalues")[3:]
        ok = fig["mds"][0] == 2 and fig["mds"][2] < 1e-5 and "basis determinant +1.000" in out
    elif name == "image_viewer":
        fig["depth_range_m"] = printed(out, "rendered")[-2:]
        ok = 0 < fig["depth_range_m"][0] < fig["depth_range_m"][1]
        ok &= all(os.path.getsize(os.path.join(out_dir, f"image_viewer_{k}.html")) > 10_000 for k in ("rgb", "depth"))
    elif name == "visualizer":
        ok = all(os.path.getsize(os.path.join(out_dir, f"visualizer_window{w}.html")) > 10_000 for w in (1, 2))
    elif name in ("convex_hull", "space_regions"):
        pass  # held line for line to the CPU run
    else:
        raise AssertionError(f"no truth for example {name}")
    if not ok:
        raise AssertionError(f"example {name}: {fig}\n{out}")
    return fig


def run_example(name, argv):
    """``main(argv)`` of ``cilantro_tpu_torch.examples.<name>``: ``(what it
    printed, host s)``; a non-zero return raises."""
    import importlib
    import io

    mod = importlib.import_module(f"cilantro_tpu_torch.examples.{name}")
    buf = io.StringIO()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"example {name} returned {rc}:\n{buf.getvalue()}")
    return buf.getvalue(), seconds


def examples_paths(card):
    """Phase 38: every example through its ``main`` on the card at its
    default input (the 120,000-point height field, 640x480 frames, the
    SLAM demo's 48 frames of 96x128), its printed truth held
    (:func:`example_truth`), its launches counted from 0, and each kernel
    it launched held bit for bit against its plain version on its last
    call there and timed beside its bound. The three host-code examples
    repeat every line on the CPU; ``mds_and_pca`` its numbers within 1e-4
    (the MDS RMS error, float32 noise, below 1e-5 on both)."""
    import tempfile

    from cilantro_tpu_torch.slam import splat
    from cilantro_tpu_torch.slam import splat_fusion as sf

    t_phase = time.perf_counter()
    paths, held = [], {}
    with tempfile.TemporaryDirectory(prefix="examples_", dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        for name in EXAMPLES:
            out_dir = os.path.join(tmp, name)
            argv = ["--device", "cuda"] + (["--out", out_dir] if name in EXAMPLES_WITH_OUT else [])
            if name == "slam":
                argv += ["--cache", out_dir]
            reset_all_counts()
            splat.reset_launch_counts()
            kept, splat_kept = {}, {}
            with last_kernel_calls(kept, PARALLEL_WRAPPERS), path_recorded(sf, splat_kept):
                out, seconds = run_example(name, argv)
            launches = {k_: v for k_, v in {**all_counts(), **splat.launch_counts}.items() if v}
            figures = example_truth(name, out, out_dir)
            cpu_same = None
            if name in EXAMPLES_AS_ON_CPU or name == "mds_and_pca":
                cpu_out, _ = run_example(name, ["--device", "cpu"] + (["--out", out_dir + "_cpu"]
                                                                       if name in EXAMPLES_WITH_OUT else []))
                if name == "mds_and_pca":
                    a, b = out.splitlines(), cpu_out.splitlines()
                    cpu_same = len(a) == len(b) and all(
                        np.allclose(printed(x, x[:12]), printed(y, y[:12]), rtol=1e-4, atol=0)
                        for x, y in zip(a[1:], b[1:])) and printed(b[0], "MDS:")[2] < 1e-5
                else:
                    cpu_same = out == cpu_out
                if not cpu_same:
                    raise AssertionError(f"example {name}: card and CPU print\n{out}\n---\n{cpu_out}")
            entries = warp_kernel_checks({k_: v for k_, v in kept.items() if k_ in launches}, launches,
                                         f"38 {name}", phase="examples_kernel_vs_plain", quick_pairs=QUICK_PAIRS)
            if splat_kept:
                for kname, e in path_frame_checks(splat, splat_kept, case=f"38 {name}: last call").items():
                    entries[kname] = dict(e, launches=launches.get(kname, 0))
            for kname, e in entries.items():
                held[f"38 {name} / {kname}"] = {f: e.get(f) for f in ("launches", "max_abs_err", "ms", "plain_ms",
                                                                       "bound_ms", "bound_by", "library_ms")}
            emit(phase="example", name=name, argv=argv, host_s=seconds, launches=launches, figures=figures,
                 same_as_cpu=cpu_same, printed=out.splitlines(), card=card)
            paths.append({"phase": 38, "path": f"examples.{name}", "host_s": seconds, "launches": launches,
                          "held_bit_exact": sorted(entries)})
    emit(phase="examples_done", phase_s=time.perf_counter() - t_phase)
    return paths, held


DRYRUN_REPLICATED = {
    "tournament_icp": ("linear", "translation", "iterations"), "ring_icp": ("linear", "translation", "iterations"),
    "ba": ("linear", "translation", "residual"), "fusion_640x480": ("poses", "widx"),
    "fusion_320x240": ("poses", "widx"), "pipeline": ("poses", "iterations", "data"),
    "warp": ("linear", "translation", "cg_iterations"),
}


def dryrun_parts(world: int, dev, timeout=None) -> dict:
    """Each part of ``entry.dryrun_multichip(world)`` on this rank
    (``entry._dryrun_parts``: its order, meshes, draws and shapes), each
    timed by :func:`event_ms`: ``{part: {host_ms, events_ms, outputs...}}``
    (numpy; ranks past 1 have no pipeline part)."""
    from cilantro_tpu_torch import entry

    times = {}

    def run(part, fn):
        h_ms, e_ms, res = event_ms(fn)
        times[part] = dict(host_ms=h_ms, events_ms=e_ms)
        return res

    def tf(res):
        return dict(zip(("linear", "translation"), tf_numpy(res[0])), iterations=int(res[1]))

    unpack = {
        "tournament_icp": tf, "ring_icp": tf,
        "ba": lambda r: dict(zip(("linear", "translation"), tf_numpy(r[0])), landmarks=r[1].cpu().numpy(),
                             residual=float(r[2])),
        "pipeline": lambda r: dict(poses=np.stack(r[1].poses), iterations=list(r[1].icp_iterations),
                                   data=r[0].data.cpu().numpy()),
        "warp": lambda r: dict(zip(("linear", "translation"), tf_numpy(r[0])), cg_iterations=int(r[2])),
    }
    fusion = lambda r: dict(poses=np.stack(r[1]), widx=r[2].cpu().numpy(), shard_rows=int(r[0].shape[0]))  # noqa: E731
    return {part: dict(times[part], **unpack.get(part, fusion)(res))
            for part, res in entry._dryrun_parts(world, dev, timeout=timeout, run=run).items() if res is not None}


def dryrun_rank_main(argv) -> int:
    """Phase 39b's rank: ``python3 chip_smoke.py --dryrun-rank RANK WORLD
    STORE OUT``. One of two gloo ranks on the one card: every part of the
    dryrun on its shards, results saved to ``OUT/dryrun<RANK>.pt``."""
    import datetime

    import torch.distributed as dist

    rank, world, store, out_dir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.cuda.set_device(0)
    timeout = datetime.timedelta(seconds=RANK_GROUP_TIMEOUT_S)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world, timeout=timeout)
    t0 = time.perf_counter()
    out = dryrun_parts(world, "cuda", timeout)
    out["seconds"] = time.perf_counter() - t0
    torch.save(out, os.path.join(out_dir, f"dryrun{rank}.pt"))
    dist.destroy_process_group()
    print(json.dumps({"rank": rank, "seconds": out["seconds"]}), flush=True)
    return 0


def dryrun_paths(card):
    """Phase 39: ``dryrun_multichip`` on the card. (a) World size 1 over
    NCCL in this process: the entry point once with its launches counted
    from 0 and each kernel held bit for bit on its last call at each input
    shape, then each part alone with host and CUDA-event ms. (b) Two gloo
    ranks on the one card as subprocesses (``--dryrun-rank``): each part's
    ms on each rank, and every replicated output the same bits on both."""
    import tempfile

    import torch.distributed as dist

    from cilantro_tpu_torch.entry import dryrun_multichip

    t_phase = time.perf_counter()
    paths, held, sharded = [], {}, {}
    if dist.is_initialized():
        raise AssertionError("phase 39 starts with no process group")
    h_ms, e_ms, (_, launches, kept) = event_ms(lambda: counted_run(lambda: dryrun_multichip(1, device="cuda")))
    if dist.is_initialized():
        raise AssertionError("dryrun_multichip(1) left its world of one behind")
    for kname in ("coalesced_gather", "nn1_fused", "project_to_rotation"):
        if not launches.get(kname):
            raise AssertionError(f"dryrun_multichip(1) launched no {kname}: {launches}")
    hold_path("39a dryrun_multichip(1)", launches, kept, held, sharded)
    parts = dryrun_parts(1, "cuda")
    dist.destroy_process_group()
    emit(phase="dryrun_world_one", backend="nccl", host_ms=h_ms, events_ms=e_ms, launches=launches,
         parts={p: {k_: v[k_] for k_ in ("host_ms", "events_ms")} for p, v in parts.items()}, card=card)
    paths.append({"phase": 39, "path": "dryrun_multichip(1), world 1 (NCCL)", "host_ms": h_ms, "events_ms": e_ms,
                  "launches": launches, "parts_events_ms": {p: v["events_ms"] for p, v in parts.items()}})

    with tempfile.TemporaryDirectory(prefix="dryrun_", dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        cmd = [sys.executable, os.path.abspath(__file__), "--dryrun-rank"]
        procs = [subprocess.Popen(cmd + [str(r), "2", os.path.join(tmp, "store"), tmp],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
        logs = []
        try:
            for p in procs:
                left = max(1.0, RANK_WAIT_S - (time.perf_counter() - t_phase))
                logs.append(p.communicate(timeout=left)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"phase 39 rank {r} exited {p.returncode}:\n{log[-3000:]}")
        res = [torch.load(os.path.join(tmp, f"dryrun{r}.pt"), weights_only=False) for r in range(2)]
    replicated = {part: all(np.array_equal(np.asarray(res[1][part][f]), np.asarray(res[0][part][f]))
                            for f in fields) for part, fields in DRYRUN_REPLICATED.items()}
    from_world_one = {part: max(float(np.abs(res[0][part][f] - parts[part][f]).max()) for f in ("linear", "translation"))
                      for part in ("tournament_icp", "ring_icp")}
    emit(phase="dryrun_two_ranks", ranks=2, backend="gloo", device="one card", replicated_identical=replicated,
         transform_diff_from_world_one=from_world_one, rank_seconds=[r["seconds"] for r in res],
         parts={p: {"host_ms": [r[p]["host_ms"] for r in res], "events_ms": [r[p]["events_ms"] for r in res]}
                for p in DRYRUN_REPLICATED}, phase_s=time.perf_counter() - t_phase, card=card)
    if not all(replicated.values()):
        raise AssertionError(f"phase 39b: replicated outputs differ across ranks: {replicated}")
    paths.append({"phase": 39, "path": "dryrun parts on 2 gloo ranks on one card",
                  "replicated_identical": replicated,
                  "parts_events_ms": {p: [r[p]["events_ms"] for r in res] for p in DRYRUN_REPLICATED}})
    return paths, held, sharded


KERNEL_SOURCES = {
    "knn_full": "cilantro_tpu_torch/csrc/knn_kernels.cu",
    "knn_compact": "cilantro_tpu_torch/csrc/knn_kernels.cu",
    "nn1_fused": "cilantro_tpu_torch/csrc/nn1_kernels.cu",
    "nn1_masked": "cilantro_tpu_torch/csrc/nn1_kernels.cu",
    "nn1_compact": "cilantro_tpu_torch/csrc/nn1_kernels.cu",
    "coalesced_gather": "cilantro_tpu_torch/csrc/gather_kernels.cu",
    "project_to_rotation": "cilantro_tpu_torch/csrc/rotation_kernels.cu",
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cilantro_tpu_torch import native
    from cilantro_tpu_torch.core import transforms as tfm
    from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
    from cilantro_tpu_torch.slam import splat
    from cilantro_tpu_torch.slam import splat_fusion as sf
    from cilantro_tpu_torch.slam.driver import ate_rmse, synthetic_sequence

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    # 1. Build the kernels and the gather's design variants (phase 37), every
    # nvcc at once, and wait for all of them before anything is timed.
    from cilantro_tpu_torch.tools import gather_variants

    t0 = time.perf_counter()
    gather_jobs = gather_variants.start_build(native)
    logs = native.build()
    designs = gather_variants.finish_build(gather_jobs)
    build_s = time.perf_counter() - t0
    emit(phase="build", seconds=build_s, sources=list(native.SOURCES), compiled=sorted(logs),
         gather_designs=[name for name, _ in designs], card=card, torch=torch.__version__, cuda=torch.version.cuda)
    for name, log in logs.items():
        emit(phase="build_log", source=name,
             ptxas=[ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln])

    # 2. Kernel vs plain on the card.
    kernels = kernel_checks(splat, dev)

    # 3. The main path: splat fusion on 16 frames of 640x480.
    k = CameraIntrinsics.kinect_640()
    cfg = sf.SplatConfig(radius=RADIUS, margin=MARGIN)
    t0 = time.perf_counter()
    depths, gt = synthetic_sequence(FRAMES, H, W, k, seed=0)
    emit(phase="input", frames=FRAMES, height=H, width=W, render_s=time.perf_counter() - t0)

    splat.reset_launch_counts()
    tfm.reset_launch_counts()
    frame_inputs = {}
    with path_recorded(sf, frame_inputs), rotation_recorded(frame_inputs):
        smap, poses, spf, per_frame = sf.run_splat_sequence(depths, k, cfg=cfg, device="cuda")
    launches = dict(splat.launch_counts)
    rotation_launches = tfm.launch_counts["project_to_rotation"]
    if rotation_launches != launches["window_read_codes"]:
        raise AssertionError(f"{rotation_launches} rotation launches, want one a GN iteration")
    ate = ate_rmse(poses, gt, device="cuda")
    pts, nrm, conf = sf.extract_cloud(smap)
    fused = FRAMES - 1
    if launches["splat_argmin2"] != fused or launches["flow_select_rows"] != fused:
        raise AssertionError(f"main path launches {launches}: want {fused} argmin2 and select rows")
    if launches["window_read_codes"] < fused:
        raise AssertionError(f"main path launches {launches}: want >= {fused} window reads")
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if not ate < 2e-3:
        raise AssertionError(f"ATE {ate} m not below 2e-3 m")
    if not (len(pts) > 0.5 * H * W and np.isfinite(pts).all() and np.isfinite(nrm).all()):
        raise AssertionError(f"map has {len(pts)} live surfels or non-finite values")
    # A second run of the same sequence: the spread of the host-clock rate.
    _, poses2, spf2, _ = sf.run_splat_sequence(depths, k, cfg=cfg, device="cuda")
    if not np.allclose(np.stack(poses), np.stack(poses2), atol=1e-5):
        raise AssertionError("two runs of the main path disagree")
    emit(
        phase="main_path", pipeline="splat", frames=FRAMES, height=H, width=W,
        radius=RADIUS, margin=MARGIN, launches=launches,
        window_reads_per_frame=[f["window_read_codes"] for f in per_frame],
        ms_per_frame=spf * 1e3, frames_per_s=1.0 / spf,
        ms_per_frame_repeat=spf2 * 1e3, frames_per_s_repeat=1.0 / spf2,
        ate_m=ate, live_surfels=len(pts), card=card,
    )
    path_frame_ms = path_frame_checks(splat, frame_inputs)
    rotation = rotation_kernel_check(tfm, frame_inputs["project_to_rotation"])
    rotation.update(launches=rotation_launches, path="splat fusion, 16 frames (one a GN iteration)")
    emit(phase="stage_split_ms_per_frame", card=card, **stage_split(sf, depths, k, cfg, dev))
    splat_busy_ms = "not measured"
    try:
        prof = profile_window(sf, depths, k, cfg, dev, spf2 * 1e3)
        splat_busy_ms = prof.get("device_kernel_ms", "not measured")
        emit(phase="profile", card=card, **prof)
    except Exception as e:  # informational phase: report and go on
        emit(phase="profile", device_busy="not measured", error=f"{type(e).__name__}: {e}")

    # 4. Card vs CPU (plain versions) on the first frames.
    _, cpu_poses, _, cpu_launches = sf.run_splat_sequence(
        depths[:CPU_FRAMES], k, cfg=cfg, device="cpu"
    )
    if any(sum(f.values()) for f in cpu_launches):
        raise AssertionError("the CPU run launched a kernel")
    dt = max(float(np.abs(a[:3, 3] - b[:3, 3]).max()) for a, b in zip(poses, cpu_poses))
    dr = max(rot_angle(a[:3, :3], b[:3, :3]) for a, b in zip(poses, cpu_poses))
    emit(phase="card_vs_cpu", frames=CPU_FRAMES, max_translation_diff_m=dt, max_rotation_diff_rad=dr)
    if not (dt < 1e-4 and dr < 1e-4):
        raise AssertionError(f"card and CPU poses differ by {dt} m / {dr} rad")

    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
        entry["path"] = "splat fusion, 16 frames"
        entry["path_frame_ms"] = path_frame_ms[entry["name"]]["ms"]

    # 5. nn1 kernels vs plain on the card.
    from cilantro_tpu_torch.entry import _toy_pair
    from cilantro_tpu_torch.neighbors import fused_nn
    from cilantro_tpu_torch.registration import icp as icp_mod

    pair = (frame_clouds(depths[1], k, dev), frame_clouds(depths[0], k, dev))
    rel = np.linalg.inv(gt[0]) @ gt[1]  # frame 1's camera in frame 0's
    coarse = coarse_clouds(*pair, BENCH_LEVELS[0])
    toy = [torch.as_tensor(a, device=dev) for a in _toy_pair()]
    nn1 = nn1_kernel_checks(fused_nn, pair, coarse, toy)

    # 6-8. The ICP paths: main path, wide gate, entry().
    nn1["nn1_compact"]["launches"] = icp_main_path(fused_nn, icp_mod, pair, rel, card)["nn1_compact"]
    nn1["nn1_compact"]["path"] = "icp_multires, 640x480 pair, bench levels"
    nn1["nn1_masked"]["launches"] = wide_gate_path(fused_nn, icp_mod, pair, rel)["nn1_masked"]
    nn1["nn1_masked"]["path"] = "icp, 640x480 pair, entry() settings (0.5 m gate)"
    nn1["nn1_fused"]["launches"] = entry_path(fused_nn)["nn1_fused"]
    nn1["nn1_fused"]["path"] = "entry(), 4096-point pair"

    # 9. ICP card vs CPU.
    icp_card_vs_cpu(fused_nn, icp_mod, CameraIntrinsics.make(131.25, 131.25, 79.5, 59.5))

    # 10-13. The pool pipeline with the gather kernel.
    from cilantro_tpu_torch.core import coalesced as cg
    from cilantro_tpu_torch.slam import fusion

    gather_launches, streams, pool_met = pool_main_path(depths, gt, k, card)
    gathers = gather_kernel_checks(cg, streams)
    gather_entry = dict(gathers["integrate_rows"], launches=gather_launches,
                        path="run_fusion_sequence, pool pipeline, 16 frames")
    emit(phase="pool_stage_split_ms_per_frame", card=card, **pool_stage_split(fusion, depths, k, dev))
    pool_busy_ms = "not measured"
    try:
        prof = pool_profile(fusion, depths, k, dev, pool_met.seconds_per_frame * 1e3)
        pool_busy_ms = prof.get("device_kernel_ms", "not measured")
        emit(phase="pool_profile", card=card, **prof)
    except Exception as e:  # informational phase: report and go on
        emit(phase="pool_profile", device_busy="not measured", error=f"{type(e).__name__}: {e}")
    try:
        emit(phase="pool_driver_frames", card=card, **pool_driver_frames(depths, k))
    except Exception as e:  # informational phase: report and go on
        emit(phase="pool_driver_frames", error=f"{type(e).__name__}: {e}")
    pool_card_vs_cpu(cg, depths, k, pool_met.poses)

    # 14-19. The neighbour engines and kNN normals with the two kNN kernels.
    from cilantro_tpu_torch.neighbors import fused_knn

    cloud0 = frame_cloud(depths[0], k, dev)
    _, ref_normals, ref_valid = pair[1]
    _, knn_launches, first_round = knn_normals_main_path(fused_knn, cloud0, ref_normals, ref_valid, card)
    try:
        eigh_yardstick(cloud0, card)
    except Exception as e:  # informational phase: report and go on
        emit(phase="eigh_yardstick", error=f"{type(e).__name__}: {e}")
    knn_normals_registration(fused_knn, fused_nn, icp_mod, pair[0], cloud0, rel)
    down, full_launches = knn_full_path(fused_knn, cloud0)
    bench_neighbour_rows(fused_knn, cloud0, card)
    knn = knn_kernel_checks(fused_knn, fused_nn, first_round, down)
    knn["knn_compact"].update(launches=knn_launches["knn_compact"],
                              path="with_normals_knn(k=12), 640x480 frame")
    knn["knn_full"].update(launches=full_launches["knn_full"],
                           path="with_normals_knn(k=12), frame grid-downsampled below 8,192 points")
    knn_normals_card_vs_cpu(fused_knn, CameraIntrinsics.make(131.25, 131.25, 79.5, 59.5))

    # 20. The wide-row probe's kernel.
    probe = probe_kernel_check()

    # 21-22. The scanned drivers: one step captured in a CUDA graph, replayed.
    scanned_splat_path(sf, depths, gt, k, cfg, poses, splat_busy_ms, card)
    scanned_pool_path(depths, gt, k, pool_met.poses, pool_busy_ms, card)

    # What any launch costs by phase 2's timer: an empty kernel (a spin of
    # 0 cycles), beside the gather's ICP stream, whose byte bound lies below it.
    emit(phase="empty_launch", kernel="torch.cuda._sleep(0)", ms=device_ms(lambda: torch.cuda._sleep(0)),
         icp_stream_gather_ms=gathers["icp_projective"]["ms"],
         icp_stream_gather_bound_ms=gathers["icp_projective"]["bound_ms"], card=card)

    # 23-25. The non-rigid warp: single and batched solves at the full
    # width, then the other routes card against CPU.
    from cilantro_tpu_torch.registration import warp_field as tw

    warp, graph_launches, solve_launches, warp_entries = warp_single_path(card)
    graph, src, dst, dsts, src_t, nodes, node_valid, _ = warp
    batched_launches = warp_batched_path(tw, graph, src, dsts, src_t, card)
    del graph, warp
    other = warp_other_routes(tw, src, dst, nodes, node_valid, card)
    warp_paths = [
        {"phase": 23, "path": "build_deformation_graph, 120,000 points", "launches": graph_launches},
        {"phase": 23, "path": "icp_warp_field, direct", "launches": solve_launches,
         "held_bit_exact": sorted(warp_entries)},
        {"phase": 24, "path": "icp_warp_field_batched, B = 8", "launches": batched_launches},
    ]
    for label, rec in other.items():
        warp_paths += [{"phase": 25, "path": f"{label}: graph", "launches": rec["graph"]},
                       {"phase": 25, "path": f"{label}: solve", "launches": rec["solve"]}]
    print(json.dumps({"warp_paths": warp_paths}), flush=True)

    # 26-27. The SLAM backend: run_slam at the bench's SLAM row, then the
    # bundle adjustment at mapping scale.
    slam_paths, slam_entries = slam_path(card)
    ba_launches, ba_entries = slam_ba_mapping(card)
    slam_paths += [
        {"phase": 26, "path": "run_slam, every kernel held bit for bit", "held_bit_exact": sorted(slam_entries)},
        {"phase": 27, "path": "bundle_adjust, K = 64, L = 100,000, O = 300,000",
         "launches": {k_: v for k_, v in ba_launches.items() if v}, "held_bit_exact": sorted(ba_entries)},
    ]
    print(json.dumps({"slam_paths": slam_paths}), flush=True)

    # 28-29. Multi-stream fusion at the bench's B = 8 row, then the
    # pipelined driver against the scanned one.
    batched_paths, _ = batched_path(card)
    batched_paths += pipelined_path(depths, k, card)
    print(json.dumps({"batched_paths": batched_paths}), flush=True)

    # 30-32. Estimation and clustering: the bench's estimation row, the
    # clustering path, then card against CPU.
    est_paths, _ = estimation_paths(pair, card)
    print(json.dumps({"estimation_paths": est_paths}), flush=True)

    # 33-34. PLY files through the host codec onto the card, then the live
    # viewer, the render and the timers on the pool path.
    g2_paths = [ply_path(depths, k, rel, card), viz_path(depths, k, streams, card)]
    print(json.dumps({"g2_paths": g2_paths}), flush=True)

    # 35-36. The multi-device paths: world size 1 over NCCL, then two gloo
    # ranks on the one card.
    par_paths, par_held, sharded_launches, ref = world_one_paths(depths, gt, k, pair, rel, card)
    par_paths += two_rank_paths(depths, k, ref, card)
    print(json.dumps({"parallel_paths": par_paths, "held_bit_exact": par_held}), flush=True)

    # 37. The gather's designs in one A/B on every stream held above.
    icp_b8 = next(label for label in GATHER_STREAMS if "batched icp_projective" in label)
    strided = gather_variants.stride_cases(GATHER_STREAMS[icp_b8][0], GATHER_STREAMS[icp_b8][1].shape[0])
    ab = gather_variants.ab(designs, {**GATHER_STREAMS, **strided}, card, cold=(*strided, icp_b8))
    built, first = gather_variants.BUILT, gather_variants.FIRST
    print(json.dumps({"gather_designs": {label: {"as_built_ms": t[built], "first_design_ms": t[first],
                                                 "ratio": t[built] / t[first]} for label, t in ab.items()}}),
          flush=True)
    gather_entry["first_design_ms"] = ab["phase 11, integrate_rows"][first]

    # 38-39. The examples through their main(), then dryrun_multichip at
    # world size 1 over NCCL and on two gloo ranks.
    ex_paths, ex_held = examples_paths(card)
    print(json.dumps({"examples_paths": ex_paths, "held_bit_exact": ex_held}), flush=True)
    dry_paths, dry_held, dry_launches = dryrun_paths(card)
    print(json.dumps({"dryrun_paths": dry_paths, "held_bit_exact": dry_held}), flush=True)
    for name, by_path in dry_launches.items():
        sharded_launches.setdefault(name, {}).update(by_path)

    # The kernels line, the card, the result.
    kernels += [nn1[name] for name in ("nn1_fused", "nn1_masked", "nn1_compact")]
    kernels.append(gather_entry)
    kernels += [knn["knn_full"], knn["knn_compact"], probe, rotation]
    for entry in kernels:
        if entry["name"] in sharded_launches:
            entry["sharded_launches"] = sharded_launches[entry["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:  # one of phase 36's ranks
        sys.exit(rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--dryrun-rank"]:  # one of phase 39's ranks
        sys.exit(dryrun_rank_main(sys.argv[2:]))
    sys.exit(main())
