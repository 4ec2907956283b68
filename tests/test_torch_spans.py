"""The spans and counters inside the port's whole-clip entries
(``run_splat_sequence_scanned``, ``run_fusion_sequence_scanned``,
``run_batched_fusion_sequences``) under a CPU ``torch.profiler``: their
names and nesting by containment, one ``cilantro.scan.step`` a step of
each pass, the GN iteration counters against what the entries return,
and results bit for bit the same with and without the profiler. No JAX.

On the CPU ``scan`` runs its 3 timed passes eagerly: no warm-up, capture
or untimed pass (those spans are held on the card,
``tests/test_torch_scanned_cuda.py``)."""

import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
from cilantro_tpu_torch.slam.batched_fusion import run_batched_fusion_sequences
from cilantro_tpu_torch.slam.driver import run_fusion_sequence_scanned, synthetic_sequence
from cilantro_tpu_torch.slam.fusion import FusionConfig
from cilantro_tpu_torch.slam.scan import RUNS
from cilantro_tpu_torch.slam.splat_fusion import SplatConfig, run_splat_sequence_scanned
from cilantro_tpu_torch.utils import profiling

H, W, FRAMES, B = 48, 64, 4, 2
K = CameraIntrinsics.make(52.5, 52.5, 31.5, 23.5)
CAP = int(1.4 * H * W)
COUNT = re.compile(r"cilantro\.count\.(\w+)=(-?\d+)$")


@pytest.fixture(scope="module")
def clips():
    return np.stack([np.stack(synthetic_sequence(FRAMES, H, W, K, seed=s)[0]) for s in (3, 4)])


def _splat(clips):
    cfg = SplatConfig(radius=2, margin=8)
    stats = {}
    smap, poses, _, _ = run_splat_sequence_scanned(list(clips[0]), K, cfg=cfg, device="cpu",
                                                   stats=stats)
    return np.stack(poses), smap.rows, stats["iterations"], cfg.icp_iterations, 1


def _fusion(clips):
    cfg = FusionConfig()
    fmap, m = run_fusion_sequence_scanned(list(clips[0]), K, map_capacity=CAP, cfg=cfg,
                                          device="cpu")
    return np.stack(m.poses), fmap.data, m.icp_iterations, cfg.icp_iterations, 1


def _batched(clips):
    cfg = FusionConfig()
    stats = {}
    data, m = run_batched_fusion_sequences(clips, K, map_capacity=CAP, cfg=cfg, device="cpu",
                                           stats=stats)
    return m.poses, data, stats["icp_iterations"], cfg.icp_iterations, B


ENTRIES = {"cilantro.entry.splat_scanned": _splat, "cilantro.entry.fusion_scanned": _fusion,
           "cilantro.entry.batched_fusion": _batched}


def _events(prof):
    """The profile's ``cilantro.`` host events, ``(name, start, end)`` in
    ns, in time order."""
    evs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.name().startswith("cilantro.")]
    return sorted(evs, key=lambda e: (e[1], -e[2]))


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _named(evs, name):
    return [e for e in evs if e[0] == name]


@pytest.fixture(scope="module", params=sorted(ENTRIES))
def traced(request, clips):
    """One entry's results untraced, then traced, and the trace's events."""
    run = ENTRIES[request.param]
    plain = run(clips)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run(clips)
    return request.param, plain, out, _events(prof)


def test_span_names_and_nesting(traced):
    entry, _, _, evs = traced
    steps = FRAMES - 1
    (root,) = _named(evs, entry)
    assert all(_inside(e, root) for e in evs)
    (prep,) = _named(evs, "cilantro.entry.prepare")
    (fin,) = _named(evs, "cilantro.entry.finish")
    passes = _named(evs, "cilantro.scan.pass.timed")
    assert len(passes) == RUNS
    assert not _named(evs, "cilantro.scan.pass.untimed")
    assert not _named(evs, "cilantro.scan.warmup") and not _named(evs, "cilantro.scan.capture")
    assert prep[2] <= passes[0][1] and passes[-1][2] <= fin[1]
    for p in passes:
        assert len([s for s in _named(evs, "cilantro.scan.step") if _inside(s, p)]) == steps
        assert len([r for r in _named(evs, "cilantro.scan.readback") if _inside(r, p)]) == 1
    assert len(_named(evs, "cilantro.scan.step")) == RUNS * steps
    names = {e[0] for e in evs if not e[0].startswith("cilantro.count.")}
    assert names == {entry, "cilantro.entry.prepare", "cilantro.entry.finish",
                     "cilantro.scan.pass.timed", "cilantro.scan.step", "cilantro.scan.readback"}


def test_gn_counters_match_returned_iterations(traced):
    entry, _, (_, _, iterations, cap, streams), evs = traced
    (fin,) = _named(evs, "cilantro.entry.finish")
    counts = [(COUNT.match(e[0]), e) for e in evs if e[0].startswith("cilantro.count.")]
    route = [(m, e) for m, e in counts if m.group(1).startswith("gn_step_route_")]
    gn = [(m, e) for m, e in counts if not m.group(1).startswith("gn_step_route_")]
    assert all(_inside(e, fin) for _, e in gn)
    found = {m.group(1): int(m.group(2)) for m, _ in gn}
    assert found == {"gn_iterations_kept": int(np.sum(iterations)),
                     "gn_iterations_run": cap * (FRAMES - 1) * streams}
    assert 0 < found["gn_iterations_kept"] <= found["gn_iterations_run"]
    # The estimator's route counters, inside the steps: on the CPU every
    # pool GN iteration (one a batch's iteration) takes the einsum route;
    # splat sums its own normal equations.
    steps = _named(evs, "cilantro.scan.step")
    assert all(m.group(0) == "cilantro.count.gn_step_route_plain=1" for m, _ in route)
    assert all(any(_inside(e, s) for s in steps) for _, e in route)
    assert len(route) == (0 if entry == "cilantro.entry.splat_scanned" else RUNS * (FRAMES - 1) * cap)


def test_results_bit_for_bit_with_and_without_profiler(traced):
    _, plain, out, _ = traced
    np.testing.assert_array_equal(plain[0], out[0])
    assert torch.equal(plain[1], out[1])
    np.testing.assert_array_equal(np.asarray(plain[2]), np.asarray(out[2]))


class _Unreadable:
    def __int__(self):
        raise AssertionError("count read its value with no profiler running")


def test_count_formats_nothing_without_profiler():
    assert not torch.autograd._profiler_enabled()
    profiling.count("x", _Unreadable())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        profiling.count("x", np.int64(3))
        with profiling.span("cilantro.outer"), profiling.annotate("cilantro.inner"):
            pass
    evs = _events(prof)
    assert [e[0] for e in evs] == ["cilantro.count.x=3", "cilantro.outer", "cilantro.inner"]
    assert _inside(evs[2], evs[1])


def test_spans_are_not_user_annotations():
    @profiling.annotate_function("cilantro.decorated")
    def work():
        return torch.ones(4) + 1

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("cilantro.span"):
            work()
    ours = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("cilantro.")]
    assert sorted(e.name() for e in ours) == ["cilantro.decorated", "cilantro.span"]
    assert not any(e.is_user_annotation() for e in ours)
