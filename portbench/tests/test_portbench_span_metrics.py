"""The readers of the program's spans and counters, on a canned trace that
holds them beside the device's events, and on traces that hold none."""

import math

import pytest

from portbench import harness, trace

# Two calls in a window of 10 s; device busy over [1, 2] and [3, 5];
# passes over [2.5, 4] and [4, 6]; 6 of 24 GN iterations kept.
SPANNED = trace.Trace(
    device_ops=[("sm90_xmma_gemm_f32f32_tf32f32", 1.0, 2.0), ("coalesced_gather_kernel", 3.0, 5.0)],
    host_ops=[("cilantro.entry.fusion_scanned", 0.0, 10.0), ("cilantro.scan.warmup", 0.5, 1.5),
              ("cilantro.scan.capture", 1.5, 2.5), ("cilantro.scan.pass.untimed", 2.5, 4.0),
              ("cilantro.scan.step", 2.6, 2.7), ("cilantro.scan.pass.timed", 4.0, 6.0),
              ("cilantro.scan.readback", 5.5, 6.0), ("cudaGraphLaunch", 4.1, 4.2),
              ("cilantro.count.gn_iterations_kept=4", 7.0, 7.0),
              ("cilantro.count.gn_iterations_run=12", 7.0, 7.0),
              ("cilantro.count.gn_iterations_kept=2", 8.0, 8.0),
              ("cilantro.count.gn_iterations_run=12", 8.0, 8.0)],
    window_s=10.0, frames=8, calls=2, steps_per_call=3)

# The same device and runtime events with none of the program's.
UNSPANNED = trace.Trace(
    device_ops=SPANNED.device_ops,
    host_ops=[("cudaGraphLaunch", 4.1, 4.2), ("aten::copy_", 6.0, 7.0)],
    window_s=10.0, frames=8, calls=2, steps_per_call=3)

SPAN_READERS = ("graph_setup_ms_per_call", "outside_pass_share", "pass_idle_share",
                "gn_useful_share")


def reader(name):
    return harness._load_reader(name)


@pytest.mark.parametrize("name,value", [
    ("graph_setup_ms_per_call", 2.0e3 / 2),
    ("outside_pass_share", 100.0 * (1.0 - 3.5 / 10.0)),
    ("pass_idle_share", 100.0 * (1.0 - 2.0 / 3.5)),
    ("gn_useful_share", 100.0 * 6 / 24),
])
def test_span_reader_on_canned_trace(name, value):
    assert math.isclose(reader(name).read(SPANNED), value, rel_tol=1e-12)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_reader_finds_nothing_without_the_programs_events(name):
    assert reader(name).read(UNSPANNED) is None
    assert reader(name).read(trace.Trace([], [], 1.0, 4, 1, 3)) is None
