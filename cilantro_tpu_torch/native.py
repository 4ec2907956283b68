"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, ``_build/lib<name>-<hash>.so``
(the hash covers the source and the flags, so an edited source rebuilds),
and loaded with ``ctypes``. Nothing is built when the package is imported:
the first CUDA call of a wrapper builds what it needs, and :func:`build`
builds several sources at once, one ``nvcc`` process each, all started
together. A failed build raises; nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("splat_kernels", "nn1_kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


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


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))


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
