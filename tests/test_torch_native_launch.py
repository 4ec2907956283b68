"""The one launch seam of the CUDA kernels (``native.launch``), on the CPU:
the built library and the current stream are replaced by stand-ins, so
each case checks what ``launch`` does around a launcher's return code.
No JAX, no card."""

import types

import pytest
import torch

from cilantro_tpu_torch import native

STREAM = 1234


class Library:
    """A stand-in for a built library: each launcher records its arguments
    and returns ``err``."""

    def __init__(self, err):
        self.err, self.calls = err, []

    def __getattr__(self, fn):
        def launcher(*args):
            self.calls.append((fn, args))
            return self.err

        return launcher


@pytest.fixture()
def library(monkeypatch):
    """Install a stand-in library (``make(err)``) and stream; the counts
    start from 0 and are put back afterwards."""
    saved = dict(native.launch_counts)
    native.reset_launch_counts()
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=STREAM))

    def make(err):
        lib = Library(err)
        monkeypatch.setattr(native, "load", lambda name: lib)
        return lib

    yield make
    native.launch_counts.update(saved)


def test_a_launch_counts_once_under_its_kernel(library):
    lib = library(0)
    native.launch("nn1_fused_launch", 1, 2, 3)
    native.launch("knn_full_warp_launch", 4)
    native.launch("knn_full_launch", 5)
    assert lib.calls == [("nn1_fused_launch", (1, 2, 3, STREAM)), ("knn_full_warp_launch", (4, STREAM)),
                         ("knn_full_launch", (5, STREAM))]
    assert {k: v for k, v in native.launch_counts.items() if v} == {"nn1_fused": 1, "knn_full": 2}


def test_a_refused_launch_raises_and_counts_nothing(library):
    library(700)
    with pytest.raises(RuntimeError, match=r"^gn_step: CUDA launch failed with error 700$"):
        native.launch("gn_step_launch", 0)
    assert set(native.launch_counts.values()) == {0}


def test_reset_zeroes_every_kernel_of_the_table(library):
    library(0)
    for fn in native._KERNEL_SIGNATURES:
        native.launch(fn)
    kernels = {kernel for _, _, kernel in native._KERNEL_SIGNATURES.values()}
    assert set(native.launch_counts) == kernels and len(kernels) == 12
    assert native.launch_counts["knn_full"] == 2 and all(native.launch_counts.values())
    native.reset_launch_counts()
    assert set(native.launch_counts) == kernels and set(native.launch_counts.values()) == {0}
