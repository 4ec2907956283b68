"""The port's remaining utilities against the JAX package on the CPU:
colormaps, matrix I/O across the packages, the roofline line (JAX's line
character for character when given JAX's peaks; the H100's figures by
default), two-count op timing and ``time_blocked`` on a stubbed clock (no
assertion rests on this machine's wall time), and profiling traces."""

import dataclasses
import importlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilantro_tpu.utils import honest_timing as jht
from cilantro_tpu.utils import io as jio
from cilantro_tpu.utils import roofline as jrl
from cilantro_tpu_torch.utils import honest_timing as tht
from cilantro_tpu_torch.utils import io as tio
from cilantro_tpu_torch.utils import profiling
from cilantro_tpu_torch.utils import roofline as trl
from cilantro_tpu_torch.utils import timer as ttimer

# ``utils.colormap`` the module is shadowed by the function of that name.
jcm = importlib.import_module("cilantro_tpu.utils.colormap")
tcm = importlib.import_module("cilantro_tpu_torch.utils.colormap")


@pytest.mark.parametrize("name", ["jet", "gray", "blue2red"])
@pytest.mark.parametrize("limits", [(None, None), (-0.5, 1.5), (0.3, 0.3)], ids=["auto", "given", "flat"])
@pytest.mark.parametrize("shape", [(257,), (6, 7)])
def test_colormaps_match_jax(name, limits, shape):
    vals = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jcm.colormap(jnp.asarray(vals), name, *limits))
    got = tcm.colormap(torch.as_tensor(vals), name, *limits)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape + (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
    fn = {"jet": tcm.colormap_jet, "gray": tcm.colormap_gray, "blue2red": tcm.colormap_blue2red}[name]
    np.testing.assert_array_equal(fn(vals, *limits, device="cpu").numpy(), got.numpy())


def test_colormap_stays_on_the_values_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcm.colormap(torch.zeros(4)).device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcm.colormap(np.zeros(4, np.float32))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_matrix_io_crosses_between_packages(tmp_path, dtype):
    m = np.random.default_rng(1).standard_normal((5, 7)).astype(dtype)
    for writer, reader in ((jio, tio), (tio, jio)):
        for binary in (True, False):
            p = str(tmp_path / f"{writer.__name__.split('.')[0]}_{binary}.txt")
            writer.write_matrix(p, m, binary=binary)
            np.testing.assert_array_equal(reader.read_matrix(p, binary=binary), m)
        raw = str(tmp_path / f"{writer.__name__.split('.')[0]}.raw")
        writer.write_matrix_raw(raw, m)
        np.testing.assert_array_equal(reader.read_matrix_raw(raw, dtype=dtype), m)
    a, b = str(tmp_path / "a.raw"), str(tmp_path / "b.raw")
    jio.write_matrix_raw(a, m)
    tio.write_matrix_raw(b, m)
    assert open(a, "rb").read() == open(b, "rb").read()


# One case per bound the line can name, and each dtype.
ROOFLINE_CASES = [
    dict(label="gemm", seconds=1e-3, flops=4e10, dtype="f32"),
    dict(label="gemm_bf16", seconds=1e-3, flops=9e10, bytes_moved=1e6, dtype="bf16"),
    dict(label="stream", seconds=1e-3, bytes_moved=2.5e9),
    dict(label="gather", seconds=2e-3, bytes_moved=1e6, rows=5e5),
    dict(label="tiny", seconds=1e-3, flops=1e6, bytes_moved=1e6),
]
V5E = dict(peak_f32=197e12 / 4.0, peak_bf16=197e12, hbm_bytes_per_s=819e9)


@pytest.mark.parametrize("case", ROOFLINE_CASES, ids=[c["label"] for c in ROOFLINE_CASES])
def test_roofline_line_matches_jax_given_its_peaks(case):
    kw = dict(case)
    label, seconds = kw.pop("label"), kw.pop("seconds")
    assert trl.roofline(label, seconds, **kw, **V5E) == jrl.roofline(label, seconds, **kw)
    line = trl.roofline(label, seconds, **kw)
    if "flops" in kw:
        assert {"f32": "(67T)", "bf16": "(989T)"}[kw.get("dtype", "f32")] in line


def test_roofline_defaults_are_the_h100s():
    line = trl.roofline("x", 1e-3, flops=1e9, bytes_moved=3.35e9, dtype="tf32")
    assert "100.0% of HBM" in line and "0.2% of tf32 peak (495T)" in line and "bandwidth-bound" in line
    assert (trl.H100_PEAK_F32, trl.H100_PEAK_TF32, trl.H100_PEAK_BF16, trl.H100_HBM) == (
        67e12, 495e12, 989e12, 3.35e12)
    src = open(trl.__file__).read()
    assert not any(s in src for s in ("V5E", "v5e", "197e12", "819e9"))


class FakeClock:
    """A host clock that moves only when read (``read_cost`` s, the floor
    of a measurement) and when the timed work runs."""

    def __init__(self, read_cost=0.0):
        self.t, self.read_cost = 100.0, read_cost

    def __call__(self):
        now = self.t
        self.t += self.read_cost
        return now


def test_op_time_on_a_stubbed_clock(monkeypatch):
    clock = FakeClock(read_cost=0.002)
    monkeypatch.setattr(tht, "_clock", clock)
    calls = []

    def fn(x):
        calls.append(1)
        clock.t += 0.001
        return x

    out = tht.op_time(fn, (torch.zeros(3),), lo=2, hi=8, reps=3)
    assert len(calls) == (1 + 3) * 2 + (1 + 3) * 8  # a warm-up and 3 reps of each loop
    assert out.per_iter_ms == pytest.approx(1.0)
    assert out.floor_ms == pytest.approx(2.0)
    assert (out.t_lo_ms, out.t_hi_ms) == (pytest.approx(4.0), pytest.approx(10.0))
    assert out.linearity == pytest.approx(2.5)
    assert str(out) == str(jht.OpTime(out.per_iter_ms, out.linearity, out.floor_ms, out.t_lo_ms, out.t_hi_ms))
    assert "SUSPECT" not in str(out)


def test_op_time_precompiled_pair_and_looped(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(tht, "_clock", clock)

    def run(ms):
        def f(x):
            clock.t += ms * 1e-3
        return f

    out = tht.op_time(None, (torch.zeros(1),), lo=2, hi=4, precompiled=(run(7.0), run(11.0)))
    assert out.per_iter_ms == pytest.approx(2.0) and out.floor_ms == pytest.approx(3.0)
    flat = tht.op_time(None, (torch.zeros(1),), precompiled=(run(5.0), run(5.5)))
    assert "SUSPECT" in str(flat)
    seen = []
    assert tht._looped(lambda x: seen.append(x) or len(seen), 5)(7) == 5 and seen == [7] * 5


@dataclasses.dataclass
class Result:
    name: str
    value: torch.Tensor


def test_time_blocked_on_a_stubbed_clock(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(ttimer, "_clock", clock)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: pytest.fail("a CPU result waited"))

    def fn(scale):
        clock.t += 0.004
        return {"a": [None, Result("r", torch.full((2,), scale))]}

    out, seconds = ttimer.time_blocked(fn, 3.0, repeats=4)
    assert seconds == pytest.approx(0.004)
    assert ttimer._first_tensor(out) is out["a"][1].value
    assert ttimer._first_tensor(("x", [1, 2])) is None
    t = ttimer.Timer()
    clock.t += 0.25
    assert t.elapsed_milliseconds() == pytest.approx(250.0)


def test_trace_records_annotations(tmp_path):
    @profiling.annotate_function("g2_decorated")
    def work(x):
        return (x @ x.T).sum()

    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir, create_perfetto_link=True) as d:
        with profiling.annotate("g2_region"):
            work(torch.ones(16, 16))
    assert d == log_dir
    with open(os.path.join(log_dir, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"g2_region", "g2_decorated"} <= names


def test_device_memory_profile_needs_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "mem.pickle"
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.device_memory_profile(str(path))
    assert not path.exists()
