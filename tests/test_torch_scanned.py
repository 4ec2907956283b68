"""The port's scanned drivers (``run_splat_sequence_scanned``,
``run_fusion_sequence_scanned``) and the graph-safe pieces under them,
against the JAX package on the CPU.

On the CPU a scanned driver runs its graph-form step eagerly, so these
tests hold the arithmetic; capture and replay run on the card
(``chip_smoke.py`` phases 21-22). Tolerances:

* the closest rotation: 2e-6 against JAX's and ``torch.linalg.svd``'s
  (float32 roundoff of two algorithms; both are 5e-7 from a float64 SVD
  on these inputs);
* the solves: ``solve_ex`` equals ``solve`` bit for bit, 1e-5 relative
  against JAX;
* the graph form of each localize loop against its early-exit form: bit
  for bit in pose and iteration count (the same iteration body);
* scanned splat against JAX's scanned splat: 1e-4 in the poses, the bound
  of ``tests/test_torch_splat_fusion.py``'s radius-2 sequence;
* scanned pool against JAX's scanned pool: 1e-4 in the poses and ATE <
  0.01 m, the bounds of ``tests/test_fusion_driver.py``'s scanned tests.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cilantro_tpu.core import transforms as jt
from cilantro_tpu.core.rgbd import CameraIntrinsics as JIntrinsics
from cilantro_tpu.slam import driver as jd
from cilantro_tpu.slam import splat_fusion as jsf
from cilantro_tpu.slam.fusion import FusionConfig as JFusionConfig
from cilantro_tpu_torch import interop, native
from cilantro_tpu_torch.core import transforms as tt
from cilantro_tpu_torch.core.rgbd import depth_to_points_normals
from cilantro_tpu_torch.registration.icp import icp_projective_packed
from cilantro_tpu_torch.slam import driver as td
from cilantro_tpu_torch.slam import splat_fusion as tsf
from cilantro_tpu_torch.slam.fusion import FusionConfig, init_map_from_frame, seed_localize_target
from cilantro_tpu_torch.slam import scan as scan_mod
from cilantro_tpu_torch.slam.scan import scan

# tests/test_splat.py:150-208: 128×160 frames, radius 2, margin 16, 3 frames.
SH, SW = 128, 160
SPLAT_K = (140.0, 140.0, SW / 2 - 0.5, SH / 2 - 0.5)
# tests/test_fusion_driver.py:37-66: 96×128 frames, 6 of them, capacity 4·H·W.
PH, PW = 96, 128
POOL_K = (120.0, 120.0, 63.5, 47.5)


def _rotations(rng, n):
    omega = rng.standard_normal((n, 3)).astype(np.float32)
    return np.array(jt.axis_angle_to_rotation(jnp.asarray(omega)))


def _svd_rotation(lin: torch.Tensor) -> torch.Tensor:
    u, _, vt = torch.linalg.svd(lin)
    sign = torch.where(torch.linalg.det(u @ vt) < 0, -1.0, 1.0)
    return torch.cat([u[..., :, :-1], u[..., :, -1:] * sign[..., None, None]], -1) @ vt


def _rotation_case(name):
    rng = np.random.default_rng(7)
    if name == "near_identity":  # what GN and ICP re-project
        lin = np.eye(3, dtype=np.float32) + 1e-6 * rng.standard_normal((64, 3, 3))
    elif name == "noisy_rotation":
        lin = _rotations(rng, 64) @ (np.eye(3) + 1e-3 * rng.standard_normal((64, 3, 3)))
    else:  # reflection: det < 0, well-separated singular values
        lin = _rotations(rng, 64) @ np.diag([2.0, 1.0, -0.3]) @ _rotations(rng, 64)
        assert (np.linalg.det(lin) < 0).all()
    return lin.astype(np.float32)


@pytest.mark.parametrize("name", ["near_identity", "noisy_rotation", "reflection"])
def test_project_to_rotation_matches_svd_and_jax(name):
    lin = _rotation_case(name)
    got = tt.project_to_rotation(torch.from_numpy(lin))
    np.testing.assert_allclose(got.numpy(), np.asarray(jt.project_to_rotation(jnp.asarray(lin))),
                               atol=2e-6, rtol=0)
    np.testing.assert_allclose(got.numpy(), _svd_rotation(torch.from_numpy(lin)).numpy(),
                               atol=2e-6, rtol=0)
    gram = np.einsum("nji,njk->nik", got.numpy(), got.numpy())
    np.testing.assert_allclose(gram, np.broadcast_to(np.eye(3), gram.shape), atol=2e-6)
    np.testing.assert_allclose(np.linalg.det(got.numpy()), 1.0, atol=2e-6)


def test_project_to_rotation_exact_cases():
    """Zero, diagonal matrices with tied and signed entries (the eigenvalue
    order's ties), and a rank-1 matrix: a proper rotation, equal to the
    SVD's where the SVD's answer is determined."""
    diag = [np.diag(d).astype(np.float32) for d in
            ([1, 1, 1], [2, 2, -1], [-1, 2, 2], [3, -3, 1], [1, 1, -1], [-2, -2, -2])]
    lin = np.stack([np.zeros((3, 3), np.float32)] + diag)
    got = tt.project_to_rotation(torch.from_numpy(lin)).numpy()
    np.testing.assert_array_equal(got[0], np.eye(3))
    np.testing.assert_allclose(got, _svd_rotation(torch.from_numpy(lin)).numpy(), atol=1e-6)
    rank1 = np.zeros((1, 3, 3), np.float32)
    rank1[0, 1, 0] = 1.0
    r = tt.project_to_rotation(torch.from_numpy(rank1)).numpy()[0]
    np.testing.assert_allclose(r.T @ r, np.eye(3), atol=1e-6)
    assert abs(np.linalg.det(r) - 1.0) < 1e-6 and r[1, 0] == 1.0


def test_solve_ex_matches_solve_and_jax():
    rng = np.random.default_rng(3)
    m = rng.standard_normal((8, 6, 6)).astype(np.float32)
    a = m @ m.transpose(0, 2, 1) + 6.0 * np.eye(6, dtype=np.float32)  # well conditioned
    b = rng.standard_normal((8, 6)).astype(np.float32)
    for ai, bi in zip(a, b):
        ta, tb = torch.from_numpy(ai), torch.from_numpy(bi)
        got = torch.linalg.solve_ex(ta, tb, check_errors=False)[0]
        assert torch.equal(got, torch.linalg.solve(ta, tb))
        want = np.asarray(jnp.linalg.solve(jnp.asarray(ai), jnp.asarray(bi)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def splat_state():
    jk = JIntrinsics.make(*SPLAT_K)
    tk = interop.intrinsics_from_numpy(jk.fx, jk.fy, jk.cx, jk.cy)
    depths, gt = jd.synthetic_sequence(3, SH, SW, jk, seed=0)
    return depths, gt, jk, tk


@pytest.mark.parametrize(
    "knobs, cap",
    [({}, False), ({"icp_convergence_tol": 0.0}, True), ({"icp_iterations": 1}, True)],
    ids=["converges", "tol0_cap", "one_iteration_cap"],
)
def test_splat_localize_graph_form_matches_host_form(splat_state, knobs, cap):
    depths, _, _, tk = splat_state
    cfg = tsf.SplatConfig(radius=2, margin=16, **knobs)
    f0 = tsf._frame_images(torch.from_numpy(depths[0]), tk, SH, SW)
    f1 = tsf._frame_images(torch.from_numpy(depths[1]), tk, SH, SW)
    smap = tsf.init_splat_map(*f0, cfg)
    guess = tt.identity(3, device="cpu")
    out = {loop: tsf.splat_localize_counted(smap, *f1, guess, tk, cfg=cfg, loop=loop)
           for loop in ("host", "graph")}
    (ph, ih), (pg, ig) = out["host"], out["graph"]
    assert torch.equal(ph.linear, pg.linear) and torch.equal(ph.translation, pg.translation)
    assert int(ih) == int(ig)
    assert (int(ig) == cfg.icp_iterations) == cap
    assert int(ig) >= 1


@pytest.fixture(scope="module")
def pool_state():
    jk = JIntrinsics.make(*POOL_K)
    tk = interop.intrinsics_from_numpy(jk.fx, jk.fy, jk.cx, jk.cy)
    depths, gt = jd.synthetic_sequence(6, PH, PW, jk, seed=0)
    return depths, gt, jk, tk


@pytest.mark.parametrize(
    "knobs, cap",
    [({}, False), ({"convergence_tol": 0.0}, True), ({"max_iterations": 1}, True)],
    ids=["converges", "tol0_cap", "one_iteration_cap"],
)
def test_icp_projective_packed_graph_form_matches_host_form(pool_state, knobs, cap):
    depths, _, _, tk = pool_state
    p0, n0, v0 = depth_to_points_normals(torch.from_numpy(depths[0]), tk)
    fmap = init_map_from_frame(4 * PH * PW, p0, n0, None, v0)
    _, packed = seed_localize_target(fmap, tt.identity(3, device="cpu"), tk, PH, PW)
    p1, n1, v1 = depth_to_points_normals(torch.from_numpy(depths[1]), tk)
    kw = dict(height=PH, width=PW, src_normals=n1, src_valid=v1, max_iterations=6,
              convergence_tol=5e-4, max_corr_dist_sq=0.01)
    kw.update(knobs)
    host = icp_projective_packed(p1, packed, tk, loop="host", **kw)
    graph = icp_projective_packed(p1, packed, tk, loop="graph", **kw)
    for field in ("iterations", "delta_norm", "converged", "num_correspondences"):
        assert torch.equal(getattr(host, field), getattr(graph, field)), field
    assert torch.equal(host.transform.linear, graph.transform.linear)
    assert torch.equal(host.transform.translation, graph.transform.translation)
    assert (int(graph.iterations) == kw["max_iterations"]) == cap


@pytest.fixture(scope="module")
def splat_runs(splat_state):
    """JAX's scanned program once, the port's scanned driver and host loop
    once each (radius 2: tests/test_splat.py:195-201 says why)."""
    depths, gt, jk, tk = splat_state
    _, jposes, _ = jsf.run_splat_sequence_scanned(depths, jk, cfg=jsf.SplatConfig(radius=2, margin=16))
    cfg = tsf.SplatConfig(radius=2, margin=16)
    stats = {}
    smap, tposes, spf, launches = tsf.run_splat_sequence_scanned(
        depths, tk, cfg=cfg, device="cpu", stats=stats
    )
    _, hposes, _, _ = tsf.run_splat_sequence(depths, tk, cfg=cfg, device="cpu")
    return dict(gt=gt, jposes=jposes, tposes=tposes, hposes=hposes, smap=smap, spf=spf,
                launches=launches, stats=stats)


def test_scanned_splat_matches_jax(splat_runs):
    r = splat_runs
    assert len(r["tposes"]) == len(r["jposes"]) == 3
    for a, b in zip(r["tposes"], r["jposes"]):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)
    assert td.ate_rmse(r["tposes"], r["gt"], device="cpu") < 2e-3
    pts, nrm, _ = tsf.extract_cloud(r["smap"])
    assert len(pts) > 0.5 * SH * SW and np.isfinite(pts).all() and np.isfinite(nrm).all()


def test_scanned_splat_matches_host_loop_bit_for_bit(splat_runs):
    r = splat_runs
    np.testing.assert_array_equal(np.stack(r["tposes"]), np.stack(r["hposes"]))
    assert r["spf"] > 0
    assert all(1 <= i <= 6 for i in r["stats"]["iterations"])
    assert len(r["stats"]["iterations"]) == 2


def test_scanned_splat_launches_nothing_on_the_cpu(splat_runs):
    r = splat_runs
    assert r["launches"] == [dict.fromkeys(tsf.KERNELS, 0)] * 2
    assert set(r["stats"]["launches_per_frame"].values()) == {0}
    assert r["stats"]["device_seconds_per_frame"] is None


@pytest.fixture(scope="module", params=[1, 2], ids=["stride1", "stride2"])
def pool_runs(request, pool_state):
    depths, gt, jk, tk = pool_state
    stride = request.param
    _, jm = jd.run_fusion_sequence_scanned(
        depths, jk, map_capacity=4 * PH * PW, cfg=JFusionConfig(localize_stride=stride)
    )
    cfg = FusionConfig(localize_stride=stride)
    stats = {}
    tmap, tm = td.run_fusion_sequence_scanned(
        depths, tk, map_capacity=4 * PH * PW, cfg=cfg, device="cpu", stats=stats
    )
    _, hm = td.run_fusion_sequence(depths, tk, map_capacity=4 * PH * PW, cfg=cfg, device="cpu")
    return dict(gt=gt, jm=jm, tm=tm, hm=hm, tmap=tmap, stats=stats)


def test_scanned_pool_matches_jax(pool_runs):
    r = pool_runs
    jm, tm = r["jm"], r["tm"]
    assert tm.frames == jm.frames == 6
    np.testing.assert_allclose(np.stack(tm.poses), np.stack(jm.poses), atol=1e-4)
    assert td.ate_rmse(tm.poses, r["gt"], device="cpu") < 0.01
    assert tm.icp_iterations[0] == 0 and all(1 <= i <= 6 for i in tm.icp_iterations[1:])
    assert tm.num_map_points == int(r["tmap"].num_points()) > PH * PW * 0.5


def test_scanned_pool_matches_host_loop_bit_for_bit(pool_runs):
    r = pool_runs
    np.testing.assert_array_equal(np.stack(r["tm"].poses), np.stack(r["hm"].poses))
    assert r["tm"].icp_iterations == r["hm"].icp_iterations
    assert r["tm"].num_map_points == r["hm"].num_map_points
    assert set(r["stats"]["launches_per_frame"].values()) == {0}


def test_scanned_drivers_one_frame_contract(splat_state, pool_state):
    """One frame: the seeded map, one identity pose, no tracking
    (tests/test_fusion_driver.py:68-82)."""
    depths, _, jk, tk = pool_state
    fmap, m = td.run_fusion_sequence_scanned(depths[:1], tk, map_capacity=4 * PH * PW, device="cpu")
    _, jm = jd.run_fusion_sequence_scanned(depths[:1], jk, map_capacity=4 * PH * PW)
    assert m.frames == 1 and len(m.poses) == 1 and m.icp_iterations == [0]
    assert np.allclose(m.poses[0], np.eye(4)) and m.seconds_per_frame == 0.0
    assert m.num_map_points == jm.num_map_points > 0
    _, m2 = td.run_fusion_sequence(depths[:1], tk, map_capacity=4 * PH * PW, device="cpu")
    assert m2.num_map_points == m.num_map_points
    sdepths, _, _, stk = splat_state
    smap, poses, spf, launches = tsf.run_splat_sequence_scanned(
        sdepths[:1], stk, cfg=tsf.SplatConfig(radius=2, margin=16), device="cpu"
    )
    assert len(poses) == 1 and np.allclose(poses[0], np.eye(4)) and spf == 0.0 and launches == []
    assert len(tsf.extract_cloud(smap)[0]) > 0.5 * SH * SW


def test_scan_runs_the_step_in_order_on_the_cpu():
    """The eager form of :func:`scan`: the carry threads through the steps,
    one ``ys`` row a step, and each of the 3 runs starts from ``carry0``."""
    calls = []

    def step(carry, x):
        calls.append(float(x))
        (acc,) = carry
        acc = acc * 2.0 + x
        return (acc,), (acc, acc.to(torch.int32))

    xs = torch.tensor([1.0, 2.0, 3.0])
    out = scan(step, (torch.tensor(0.0),), xs)
    np.testing.assert_array_equal(out.ys[0], [1.0, 4.0, 11.0])
    np.testing.assert_array_equal(out.ys[1], [1, 4, 11])
    assert float(out.carry[0]) == 11.0 and calls == [1.0, 2.0, 3.0] * 3
    assert out.device_seconds_per_step is None
    assert out.launches_per_step == dict.fromkeys(native.launch_counts, 0)


def _doubling_step(carry, x):
    (acc,) = carry
    acc = acc * 2.0 + x
    return (acc,), (acc, acc.to(torch.int32))


def _graph_counters(prof):
    return [e.name for e in prof.events() if e.name.startswith("cilantro.count.scan_graph_")]


def test_keyed_scan_on_the_cpu_equals_keyless():
    """A key changes nothing on the CPU: the same carry and ``ys`` as a
    keyless call, no ``scan_graph_*`` counter under a profiler and no
    graph kept."""
    xs = torch.tensor([1.0, 2.0, 3.0])
    plain = scan(_doubling_step, (torch.tensor(0.0),), xs)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        keyed = scan(_doubling_step, (torch.tensor(0.0),), xs, key=("site", 1.0))
    assert [e.name for e in prof.events()].count("cilantro.scan.step") == 3 * 3
    assert not _graph_counters(prof)
    assert not scan_mod._kept
    assert torch.equal(plain.carry[0], keyed.carry[0])
    for a, b in zip(plain.ys, keyed.ys):
        np.testing.assert_array_equal(a, b)
    assert keyed.launches_per_step == plain.launches_per_step == dict.fromkeys(native.launch_counts, 0)


def test_kept_graph_one_slot_a_site(monkeypatch):
    """The card's lookup with a stand-in for the capture: a keyed call
    reuses its site's step only where key, carry shapes and dtypes and the
    ``x`` shape and dtype all match; any other call of the site captures
    and takes the slot; sites keep apart; a keyless call keeps nothing;
    ``clear`` drops every slot. One counter a keyed call."""
    captured = []

    class Capture:
        def __init__(self, step, carry0, x0):
            captured.append(self)

    monkeypatch.setattr(scan_mod, "_GraphStep", Capture)
    monkeypatch.setattr(scan_mod, "_kept", {})
    carry, x = (torch.zeros(2), torch.zeros((), dtype=torch.int32)), torch.zeros(3)

    def get(key, carry=carry, x=x):
        return scan_mod._graph_step(_doubling_step, carry, x, key)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        a = get(("a", 1.0))
        assert get(("a", 1.0)) is a
        assert get(None) is not a and get(("a", 1.0)) is a
        b = get(("b", 1.0))
        assert get(("a", 1.0)) is a and get(("b", 1.0)) is b
        for other in (dict(key=("a", 2.0)), dict(carry=(torch.zeros(3), carry[1])),
                      dict(carry=(carry[0], torch.zeros((), dtype=torch.int64))),
                      dict(x=torch.zeros(4)), dict(x=torch.zeros(3, dtype=torch.float64))):
            kw = {"key": ("a", 1.0), **other}
            fresh = get(**kw)
            assert fresh is not a and get(**kw) is fresh
            a = get(("a", 1.0))
            assert a is not fresh and get(("a", 1.0)) is a
        assert set(scan_mod._kept) == {"a", "b"}
        scan_mod.clear()
        assert not scan_mod._kept
        assert get(("a", 1.0)) is not a
    counts = _graph_counters(prof)
    assert len(captured) == 1 + 1 + 1 + 5 * 2 + 1
    assert counts.count("cilantro.count.scan_graph_captured=1") == len(captured) - 1
    assert counts.count("cilantro.count.scan_graph_reused=1") == 4 + 5 * 2


def test_scanned_drivers_default_to_the_card(monkeypatch):
    """Asked for nothing, both drivers run on the card, and without one
    they raise rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    depths = [np.ones((32, 40), np.float32)] * 2
    k = interop.intrinsics_from_numpy(*POOL_K)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsf.run_splat_sequence_scanned(depths, k)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        td.run_fusion_sequence_scanned(depths, k)
