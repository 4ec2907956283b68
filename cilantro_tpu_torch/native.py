"""Build and load the port's native code: the CUDA kernels, and the host
C++ (the PLY codec and the CPU baselines).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, ``_build/lib<name>-<hash>.so``
(the hash covers the source and the flags, so an edited source rebuilds),
and loaded with ``ctypes``. Nothing is built when the package is imported:
the first CUDA call of a wrapper builds what it needs, and :func:`build`
builds several sources at once, one ``nvcc`` process each, all started
together. A failed build raises; nothing falls back to the plain versions.

Every launcher is declared once, in ``_KERNEL_SIGNATURES``, with its
library, its ``ctypes`` signature and the kernel it counts under, and every
wrapper launches through :func:`launch`, which enqueues on the current
stream, raises if the launcher returns an error and adds one to
``launch_counts[<kernel>]`` (every kernel's count, 0 from import;
:func:`reset_launch_counts` zeroes them).

The host code (``csrc/host/*.cpp``, copies of the JAX package's
``native/src``) is built the same way with ``g++ -O3 -march=native`` into
``_build/lib<name>-<hash>.so`` (the hash covers the source, the headers
beside it, the flags and the CPU ``-march=native`` resolves to) at first use, and bound with ``ctypes``:
:func:`ply_read_native`, :func:`ply_write_native` and the single-core
baselines take and return numpy arrays. A failed ``g++`` raises with the
compiler's message.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = (
    "splat_kernels", "nn1_kernels", "gather_kernels", "knn_kernels", "probe_kernels",
    "rotation_kernels", "gn_kernels",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# Each CUDA launcher's ctypes signature, the stream last, and the kernel
# its launches count under: function -> (library, argtypes, kernel).
_KERNEL_SIGNATURES = {
    "window_read_codes_launch": (
        "splat_kernels", (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P), "window_read_codes"),
    "splat_argmin2_launch": (
        "splat_kernels", (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P), "splat_argmin2"),
    "flow_select_rows_launch": (
        "splat_kernels", (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P), "flow_select_rows"),
    "nn1_fused_launch": ("nn1_kernels", (_P, _P, _I, _I, _I, _P, _P, _P, _P, _P), "nn1_fused"),
    "nn1_masked_launch": ("nn1_kernels", (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P), "nn1_masked"),
    "nn1_compact_launch": (
        "nn1_kernels", (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P), "nn1_compact"),
    "knn_full_launch": (
        "knn_kernels", (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P), "knn_full"),
    "knn_full_warp_launch": (
        "knn_kernels", (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P), "knn_full"),
    "knn_compact_launch": (
        "knn_kernels",
        (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P), "knn_compact"),
    "coalesced_gather_launch": ("gather_kernels", (_P, _P, _P, _I, _I, _I, _P), "coalesced_gather"),
    "project_to_rotation_launch": ("rotation_kernels", (_P, _P, _I, _P), "project_to_rotation"),
    "gn_step_launch": (
        "gn_kernels", (_P, _I, _P, _I, _P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P), "gn_step"),
    "scale2_launch": ("probe_kernels", (_P, _P, ctypes.c_long, _P), "scale2"),
}
# Launches of each kernel since import or the last reset_launch_counts().
launch_counts: Dict[str, int] = dict.fromkeys((kernel for _, _, kernel in _KERNEL_SIGNATURES.values()), 0)


def reset_launch_counts() -> None:
    for kernel in launch_counts:
        launch_counts[kernel] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels are compiled from csrc/ at first use"
    )


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that has no library yet, one ``nvcc``
    each, all at once. Returns the compiler's output (register and shared
    memory use, from ``-Xptxas=-v``) for each source it compiled."""
    BUILD_DIR.mkdir(exist_ok=True)
    running = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[name] = (proc, tmp, lib)
    logs, failed = {}, []
    for name, (proc, tmp, lib) in running.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{logs[name]}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def declare(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """``lib`` with the signatures of ``csrc/<name>.cu``'s launchers
    declared (a library built from that source or from a variant of it)."""
    for fn, (lib_name, argtypes, _) in _KERNEL_SIGNATURES.items():
        if lib_name == name:
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` with its launchers'
    signatures declared, building it if needed."""
    build((name,))
    return declare(ctypes.CDLL(str(library_path(name))), name)


def launch(fn: str, *args) -> None:
    """Call launcher ``fn`` with ``args`` and the current stream; raises if
    it returns an error, else counts one launch of its kernel."""
    lib, _, kernel = _KERNEL_SIGNATURES[fn]
    err = getattr(load(lib), fn)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")
    launch_counts[kernel] += 1


def on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """For a kernel wrapper: True if every tensor lies on the CPU (plain
    version), False if all lie on one CUDA device (kernel); raises
    otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return False


def check(name: str, t: torch.Tensor, what: str, dtypes, shape) -> None:
    """For a kernel wrapper: ``t`` has one of ``dtypes``, the given shape,
    and fewer than 2^31 elements (the kernels index with 32 bits)."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: {what} has dtype {t.dtype}, wants {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, wants {tuple(shape)}")
    if t.numel() >= 2**31:
        raise ValueError(f"{name}: {what} has 2^31 elements or more")


# ---------------------------------------------------------------------------
# Host C++: the PLY codec and the single-core CPU baselines.
# ---------------------------------------------------------------------------

HOST_CSRC = CSRC / "host"
HOST_SOURCES = ("ply_codec", "baseline_icp", "baseline_fusion", "baseline_warp")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


@functools.cache
def _native_target() -> str:
    """The CPU that ``-march=native`` resolves to on this machine: a
    library built for another CPU may use instructions this one lacks."""
    try:
        out = subprocess.run(["g++", "-march=native", "-Q", "--help=target"], capture_output=True, text=True,
                             timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return " ".join(ln.split()[-1] for ln in out.splitlines() if ln.strip().startswith(("-march=", "-mtune=")))


def host_library_path(name: str, src_dir: Path = HOST_CSRC) -> Path:
    """``_build/lib<name>-<hash>.so`` for ``src_dir/<name>.cpp``; the hash
    covers the source, every header in ``src_dir``, the flags and the CPU
    the build targets."""
    h = hashlib.sha256((src_dir / f"{name}.cpp").read_bytes())
    for hdr in sorted(src_dir.glob("*.hpp")):
        h.update(hdr.name.encode() + hdr.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode() + _native_target().encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_host(names: Iterable[str] = HOST_SOURCES, src_dir: Path = HOST_CSRC) -> Dict[str, str]:
    """Compile every named ``src_dir/<name>.cpp`` that has no library yet,
    one ``g++`` each, all at once; raises with the compiler's message if one
    fails. Returns the compiler's output for each source it compiled."""
    BUILD_DIR.mkdir(exist_ok=True)
    running = {}
    for name in names:
        lib = host_library_path(name, src_dir)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = ["g++", *GXX_FLAGS, str(src_dir / f"{name}.cpp"), "-o", str(tmp)]
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"g++ not found: the host code is compiled from {src_dir} at first use") from e
        running[name] = (proc, tmp, lib)
    logs, failed = {}, []
    for name, (proc, tmp, lib) in running.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"{name}: g++ exited {proc.returncode}\n{logs[name]}")
    if failed:
        raise RuntimeError("host C++ build failed:\n" + "\n".join(failed))
    return logs


_fp = ctypes.POINTER(ctypes.c_float)
_ip = ctypes.POINTER(ctypes.c_int32)
_dp = ctypes.POINTER(ctypes.c_double)
_i64 = ctypes.c_int64
# Each host function's ctypes signature: (library, function) -> (restype, argtypes).
_HOST_SIGNATURES = {
    ("ply_codec", "ply_read"): (
        ctypes.c_int, [ctypes.c_char_p, ctypes.POINTER(_fp), ctypes.POINTER(_fp), ctypes.POINTER(_fp),
                       ctypes.POINTER(_i64)]),
    ("ply_codec", "ply_write"): (ctypes.c_int, [ctypes.c_char_p, _fp, _fp, _fp, _i64, ctypes.c_int]),
    ("ply_codec", "ply_free"): (None, [ctypes.c_void_p]),
    ("baseline_icp", "baseline_icp"): (
        ctypes.c_int, [_fp, _fp, _fp, _i64, _i64, ctypes.c_int, ctypes.c_float, ctypes.c_float, _fp, _dp]),
    ("baseline_icp", "baseline_knn"): (
        ctypes.c_int, [_fp, _i64, _fp, _i64, ctypes.c_int, ctypes.c_int, _ip, _fp, _dp, _dp]),
    ("baseline_icp", "baseline_radius"): (
        ctypes.c_int, [_fp, _i64, _fp, _i64, ctypes.c_float, ctypes.c_int, ctypes.c_int, _ip, _fp, _ip,
                       _dp, _dp]),
    ("baseline_fusion", "baseline_fusion"): (
        ctypes.c_int, [_fp, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                       ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float, _fp, _dp]),
    ("baseline_warp", "baseline_warp"): (
        ctypes.c_int, [_fp, _fp, _i64, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                       ctypes.c_float, _fp, _dp, ctypes.POINTER(ctypes.c_int)]),
}


@functools.cache
def load_host(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/host/<name>.cpp`` with its functions'
    signatures declared, building it if needed (raises if ``g++`` fails)."""
    build_host((name,))
    lib = ctypes.CDLL(str(host_library_path(name)))
    for (lib_name, fn), (restype, argtypes) in _HOST_SIGNATURES.items():
        if lib_name == name:
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
    return lib


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def _ptr(a: Optional[np.ndarray]):
    return ctypes.cast(None, _fp) if a is None else a.ctypes.data_as(_fp)


def ply_read_native(
    path: str,
) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """Read a PLY with the C++ codec: ``(points (N, 3), normals or None,
    colors in [0, 1] or None)``, float32. Raises ValueError on a parse
    error and RuntimeError if the codec does not build."""
    lib = load_host("ply_codec")
    pts_p, nrm_p, col_p = _fp(), _fp(), _fp()
    n = _i64(0)
    rc = lib.ply_read(str(path).encode(), ctypes.byref(pts_p), ctypes.byref(nrm_p), ctypes.byref(col_p),
                      ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"native PLY parse failed ({rc}): {path}")

    def take(ptr):
        if not ptr:
            return None
        arr = np.ctypeslib.as_array(ptr, shape=(n.value, 3)).copy()
        lib.ply_free(ptr)
        return arr

    return take(pts_p), take(nrm_p), take(col_p)


def ply_write_native(
    path: str,
    points: np.ndarray,
    normals: Optional[np.ndarray] = None,
    colors: Optional[np.ndarray] = None,
    binary: bool = True,
) -> bool:
    """Write a PLY with the C++ codec (binary little-endian or ASCII);
    True when written. Raises RuntimeError if the codec does not build."""
    lib = load_host("ply_codec")
    pts = _f32(points)
    nrm = None if normals is None else _f32(normals)
    col = None if colors is None else _f32(colors)
    rc = lib.ply_write(str(path).encode(), _ptr(pts), _ptr(nrm), _ptr(col), len(pts), 1 if binary else 0)
    return rc == 0


def native_available() -> bool:
    """True if the C++ PLY codec builds and loads here."""
    try:
        load_host("ply_codec")
    except (RuntimeError, OSError):
        return False
    return True


def baseline_icp_native(
    src: np.ndarray,
    dst: np.ndarray,
    dst_normals: np.ndarray,
    *,
    max_iterations: int = 15,
    max_corr_dist_sq: float = 0.01,
    convergence_tol: float = 1e-5,
) -> Tuple[np.ndarray, int, float]:
    """Single-core C++ kd-tree point-to-plane ICP, the compiled CPU
    baseline (reference algorithm ``examples/rigid_icp.cpp:116-133``).
    Returns ``(transform (3, 4) [R|t], iterations, milliseconds)``."""
    lib = load_host("baseline_icp")
    s, d, dn = _f32(src), _f32(dst), _f32(dst_normals)
    out_tf = np.zeros(12, np.float32)
    out_ms = ctypes.c_double(0.0)
    it = lib.baseline_icp(_ptr(s), _ptr(d), _ptr(dn), len(s), len(d), max_iterations, max_corr_dist_sq,
                          convergence_tol, _ptr(out_tf), ctypes.byref(out_ms))
    if it < 0:
        raise ValueError(f"baseline_icp failed ({it})")
    return out_tf.reshape(3, 4), it, out_ms.value


def baseline_knn_native(
    keys: np.ndarray,
    queries: np.ndarray,
    k: int,
    *,
    exclude_self: bool = False,
) -> Tuple[np.ndarray, np.ndarray, float, float]:
    """Single-core C++ kd-tree kNN (reference ``core/kd_tree.hpp:199-236``).
    Returns ``(idx (Q, k) int32 with -1 pads, dist² (Q, k), build_ms,
    query_ms)``."""
    lib = load_host("baseline_icp")
    ks, qs = _f32(keys), _f32(queries)
    out_i = np.zeros((len(qs), k), np.int32)
    out_d = np.zeros((len(qs), k), np.float32)
    b_ms, q_ms = ctypes.c_double(0.0), ctypes.c_double(0.0)
    rc = lib.baseline_knn(_ptr(ks), len(ks), _ptr(qs), len(qs), k, 1 if exclude_self else 0,
                          out_i.ctypes.data_as(_ip), _ptr(out_d), ctypes.byref(b_ms), ctypes.byref(q_ms))
    if rc != 0:
        raise ValueError(f"baseline_knn failed ({rc})")
    return out_i, out_d, b_ms.value, q_ms.value


def baseline_radius_native(
    keys: np.ndarray,
    queries: np.ndarray,
    radius: float,
    max_neighbors: int,
    *,
    exclude_self: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float, float]:
    """Single-core C++ kd-tree radius query with a capped list and an
    in-radius count (reference ``core/kd_tree.hpp:236-273``). Returns
    ``(idx (Q, k) int32 with -1 pads, dist² (Q, k), in-radius count (Q,)
    int32, build_ms, query_ms)``."""
    lib = load_host("baseline_icp")
    ks, qs = _f32(keys), _f32(queries)
    k = int(max_neighbors)
    out_i = np.zeros((len(qs), k), np.int32)
    out_d = np.zeros((len(qs), k), np.float32)
    out_c = np.zeros(len(qs), np.int32)
    b_ms, q_ms = ctypes.c_double(0.0), ctypes.c_double(0.0)
    rc = lib.baseline_radius(_ptr(ks), len(ks), _ptr(qs), len(qs), float(radius) ** 2, k,
                             1 if exclude_self else 0, out_i.ctypes.data_as(_ip), _ptr(out_d),
                             out_c.ctypes.data_as(_ip), ctypes.byref(b_ms), ctypes.byref(q_ms))
    if rc != 0:
        raise ValueError(f"baseline_radius failed ({rc})")
    return out_i, out_d, out_c, b_ms.value, q_ms.value


def baseline_fusion_native(
    depths: np.ndarray,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    *,
    icp_iters: int = 6,
    fuse_depth: float = 0.01,
    occlusion_depth: float = 0.025,
) -> Tuple[np.ndarray, float]:
    """Single-core C++ frame-to-model fusion: projective ICP and
    fuse / augment / carve, the pool pipeline's algorithm (reference
    ``examples/fusion.cpp:125-254``). ``depths``: (F, H, W) float32.
    Returns ``(poses (F, 4, 4) camera-to-world, ms for frames 1..F-1 timed
    inside the library)``."""
    lib = load_host("baseline_fusion")
    d = _f32(depths)
    f, h, w = d.shape
    out_poses = np.zeros((f, 4, 4), np.float32)
    out_ms = ctypes.c_double(0.0)
    rc = lib.baseline_fusion(_ptr(d), f, h, w, fx, fy, cx, cy, icp_iters, fuse_depth, occlusion_depth,
                             _ptr(out_poses), ctypes.byref(out_ms))
    if rc != 0:
        raise ValueError(f"baseline_fusion failed ({rc})")
    return out_poses, out_ms.value


def baseline_warp_native(
    src: np.ndarray,
    dst: np.ndarray,
    *,
    ctrl_res: float = 0.025,
    k_anchors: int = 4,
    k_arcs: int = 8,
    max_outer: int = 10,
    max_cg: int = 200,
    point_weight: float = 1.0,
    stiffness: float = 50.0,
    huber_delta: float = 1e-2,
    max_corr_dist_sq: float = 0.0025,
    conv_tol: float = 2.5e-3,
) -> Tuple[np.ndarray, int, int, float]:
    """Single-core C++ sparse (EDG) non-rigid ICP (reference algorithm
    ``registration/warp_field_estimation.hpp:1387-1847`` via
    ``examples/non_rigid_icp.cpp:41-84``). Returns ``(warped_src (N, 3),
    outer_iterations, num_nodes, milliseconds)``; the time covers the whole
    pipeline."""
    lib = load_host("baseline_warp")
    s, d = _f32(src), _f32(dst)
    n = len(s)
    out_warped = np.zeros((n, 3), np.float32)
    out_ms = ctypes.c_double(0.0)
    out_nodes = ctypes.c_int(0)
    it = lib.baseline_warp(_ptr(s), _ptr(d), n, ctrl_res, k_anchors, k_arcs, max_outer, max_cg, point_weight,
                           stiffness, huber_delta, max_corr_dist_sq, conv_tol, _ptr(out_warped),
                           ctypes.byref(out_ms), ctypes.byref(out_nodes))
    if it < 0:
        raise ValueError(f"baseline_warp failed ({it})")
    return out_warped, it, out_nodes.value, out_ms.value
