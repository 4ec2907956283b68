"""Each per-layer reader's arithmetic on a canned trace, and the
breakdown's gaps and their host labels."""

import math

import pytest

from portbench import harness, trace

# Device: kernels at [0, 1], [0.5, 2] (overlap), [3, 4], a copy at [6, 6.5];
# host: two graph launches, a sync spanning the gap [4, 6].
CANNED = trace.Trace(
    device_ops=[("void splat_argmin2_kernel<4>(...)", 0.0, 1.0),
                ("coalesced_gather_kernel<4>", 0.5, 2.0),
                ("sm90_xmma_gemm_f32f32_tf32f32", 3.0, 4.0),
                ("Memcpy HtoD (Pageable -> Device)", 6.0, 6.5)],
    host_ops=[("cudaGraphLaunch", 0.0, 0.1), ("cudaGraphLaunch", 2.0, 2.1),
              ("aten::copy_", 4.0, 6.0), ("cudaStreamSynchronize", 4.5, 5.8)],
    window_s=10.0, frames=4, calls=1, steps_per_call=2)


def reader(name):
    return harness._load_reader(name)


@pytest.mark.parametrize("name,value", [
    ("passes_per_clip", 1.0),
    ("device_ms_per_frame", 3.5e3 / 4),
    ("device_idle_share", 65.0),
    ("kernel_ms_per_frame.splat", 1e3 / 4),
    ("kernel_ms_per_frame.gather", 1.5e3 / 4),
    ("kernel_ms_per_frame.gemm", 1e3 / 4),
])
def test_reader_on_canned_trace(name, value):
    assert math.isclose(reader(name).read(CANNED), value, rel_tol=1e-12)


@pytest.mark.parametrize("name", ["passes_per_clip", "device_ms_per_frame", "device_idle_share",
                                  "kernel_ms_per_frame.splat", "kernel_ms_per_frame.gather",
                                  "kernel_ms_per_frame.gemm"])
def test_reader_finds_nothing_on_an_empty_trace(name):
    empty = trace.Trace([], [], 1.0, 4, 1, 3)
    assert reader(name).read(empty) is None


def test_breakdown_gaps_named_by_innermost_host_op():
    b = trace.breakdown(CANNED)
    assert b["device_ops"][0][0].startswith("coalesced_gather")
    assert [g[0] for g in b["idle_gaps"]] == ["cudaStreamSynchronize", "(no host op)"]
    assert [g[1] for g in b["idle_gaps"]] == [2.0, 1.0]
    assert math.isclose(CANNED.busy_s(), 3.5)
