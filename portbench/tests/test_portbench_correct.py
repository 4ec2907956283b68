"""``correct`` on small cells on the CPU: true for the measured entries;
false with the TF32 control in the program's place, and with the timed
path broken underneath each way a cell can break (a step that leaves its
state unchanged, half of a batch left out, an answer altered where it is
produced: a pose, the map's points, a quarter of its rows made invalid,
its confidences). Each run is a whole run of the harness but for the look for a
card."""


import numpy as np
import pytest
import torch

from portbench import harness
from portbench.pipelines import Output
from portbench.reference import pool as ref_pool
from portbench.reference import splat as ref_splat
from portbench.tests.portbench_cases import CELLS, small_cell


class Broken:
    """The cell's pipeline with its entry calls broken by ``fault``."""

    def __init__(self, pipe, fault):
        self.pipe, self.fault = pipe, fault

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def call(self, inp):
        if self.fault == "control":
            return harness.control_call(self.pipe, inp, "cpu")
        if self.fault == "unchanged":  # no step moves the state: the seed's map and pose
            out = self.pipe.call(inp[:, :1])
            return Output(np.repeat(out.poses, inp.shape[1], axis=1), out.maps,
                          inp.shape[0] * inp.shape[1])
        if self.fault == "half_batch":  # the second half served the first half's results
            half = inp.shape[0] // 2
            out = self.pipe.call(inp[:half])
            return Output(np.concatenate([out.poses, out.poses]), out.maps + out.maps,
                          inp.shape[0] * inp.shape[1])
        out = self.pipe.call(inp)
        if self.fault == "pose_altered":
            out.poses = out.poses.copy()
            out.poses[-1, -1, 0, 3] += 1e-3
        elif self.fault == "map_altered":
            out.maps = [m.clone() for m in out.maps]
            out.maps[-1].view(-1)[2::8 if out.maps[-1].dim() == 4 else 16] += 1e-3
        elif self.fault in ("rows_invalidated", "confidence_altered"):
            out.maps = [m.clone() for m in out.maps]
            m = out.maps[-1]
            # (C, 16) pool rows or (2, 8, H, W) surfel layers: channel views.
            ref = ref_splat if m.dim() == 4 else ref_pool
            valid, conf = m[:, ref.VALID], m[:, ref.CONF]
            live = valid > 0.5
            if self.fault == "rows_invalidated":
                drop = torch.zeros(live.numel(), dtype=torch.bool)
                drop[torch.nonzero(live.reshape(-1))[::4, 0]] = True
                valid[drop.reshape(live.shape)] = 0.0
            else:
                conf[live] += 1.0
        return out


def run(name, fault=None, seed=2**31 + 3):
    cell = small_cell(name)
    pipe = harness.make_pipeline(cell, "cpu")
    if fault:
        pipe = Broken(pipe, fault)
    return harness.run_cell(cell, seed, 0.0, False, "cpu", pipeline=pipe)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = run(name)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] == 1
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == {"pose_gap_m", "pose_gap_rad", "map_gap_m", "map_one_side_share",
                                "map_normal_gap", "map_conf_gap"}


@pytest.mark.parametrize("name,fault", [
    (n, f) for n in CELLS for f in ("control", "unchanged", "pose_altered", "map_altered",
                                  "rows_invalidated", "confidence_altered")
] + [("pool.streams8", "half_batch")])
def test_control_and_faults_are_not_correct(name, fault):
    r = run(name, fault)
    assert not r["correct"], r["checks"]


class Streams:
    """A pipeline stub whose reference poses are the identity: one stream
    a call, maps not compared."""

    def reference(self, inp, device):
        return Output(np.tile(np.eye(4), (1, 3, 1, 1)), [None], 3)


@pytest.mark.parametrize("over,expect", [("largest", 1e-3), ("median", 1e-6)])
def test_numbers_taken_over_streams(over, expect):
    prog = np.tile(np.eye(4), (8, 1, 3, 1, 1))
    prog[:, 0, -1, 0, 3] = 1e-6
    prog[0, 0, -1, 0, 3] = 1e-3  # one stream of eight far off
    rec = harness.Record(poses={i: [prog[i]] for i in range(8)}, maps={})
    got = harness.compare_outputs(Streams(), list(range(8)), np.tile(np.eye(4), (8, 1, 3, 1, 1)),
                                  rec, "cpu", {}, over)
    assert got["pose_gap_m"] == pytest.approx(expect)
    assert got["largest"]["pose_gap_m"] == pytest.approx(1e-3)
    assert len(got["per_stream"]) == 8 and got["stream_calls_compared"] == 8


@pytest.mark.parametrize("name,over", [("splat.clip16", "median"), ("pool.clip16", "largest"),
                                       ("pool.streams8", "largest")])
def test_cell_takes_its_statistic_from_its_limits_file(name, over):
    assert harness.load_cell(name).over_streams == over


@pytest.mark.parametrize("over", ["largest", "median"])
def test_a_number_that_is_nan_fails(over):
    vals = [1e-6] * 7 + [float("nan")]
    assert np.isnan(harness.OVER_STREAMS[over](vals))
    assert not harness.compare.within({"x": float(harness.OVER_STREAMS[over](vals))}, {"x": 1.0})


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_compares_every_input(name):
    cell = small_cell(name)
    pipe = harness.make_pipeline(cell, "cpu")
    r = harness.run_cell(cell, 2**31 + 5, 0.0, True, "cpu", pipeline=pipe)
    assert r["correct"], r["checks"]
    assert r["attempted"] == cell.traffic["trace_calls"] < len(pipe.inputs(
        np.zeros((cell.traffic["distinct_clips"], 1, 1, 1))))
    info = r["info"]
    assert info["maps_compared"] + info["streams_rounding_decided"] == \
        cell.traffic["distinct_clips"]
