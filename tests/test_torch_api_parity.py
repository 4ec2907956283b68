"""Every ported module keeps the JAX package's public surface: each public
function and class the JAX module defines exists in the port's
counterpart, with JAX's parameters (names, kinds, defaults) first and only
defaulted parameters after them (``device``, ``stats``, the graph-form
``loop``), and each class with JAX's members and dataclass fields.

The exclusions are the ones ROADMAP.md's Queue 3 records, each with its
reason below: the one JAX module with no counterpart, parameters the port
removed by design, and the Pallas-only ``interpret`` switch (the port
picks a kernel's plain version by the tensor's device). Then the members
Queue 3 found missing are held to JAX's behaviour on the CPU."""

import dataclasses
import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# (JAX module, port modules) under cilantro_tpu / cilantro_tpu_torch.
MODULES = [
    ("core.coalesced", ["core.coalesced"]),
    ("core.containers", ["core.containers"]),
    ("core.covariance", ["core.covariance"]),
    ("core.grid", ["core.grid"]),
    ("core.normals", ["core.normals"]),
    ("core.pair_evaluators", ["core.pair_evaluators"]),
    ("core.pca", ["core.pca"]),
    ("core.rgbd", ["core.rgbd"]),
    ("core.transforms", ["core.transforms"]),
    ("clustering.connected_components", ["clustering.connected_components"]),
    ("clustering.kmeans", ["clustering.kmeans"]),
    ("clustering.mean_shift", ["clustering.mean_shift"]),
    ("clustering.spectral", ["clustering.spectral"]),
    ("correspondence.projective", ["correspondence.projective"]),
    ("correspondence.search", ["correspondence.search"]),
    ("model_estimation.ransac", ["model_estimation.ransac"]),
    ("neighbors.api", ["neighbors.api"]),
    ("neighbors.bruteforce", ["neighbors.bruteforce"]),
    ("neighbors.gridhash", ["neighbors.gridhash"]),
    ("neighbors.pallas_nn", ["neighbors.fused_nn", "neighbors.fused_knn"]),
    ("registration.icp", ["registration.icp"]),
    ("registration.transform_estimation", ["registration.transform_estimation"]),
    ("registration.warp_field", ["registration.warp_field"]),
    ("registration.warp_field_batched", ["registration.warp_field_batched"]),
    ("slam.driver", ["slam.driver"]),
    ("slam.fusion", ["slam.fusion"]),
    ("slam.splat", ["slam.splat"]),
    ("slam.splat_fusion", ["slam.splat_fusion"]),
    ("slam.pose_graph", ["slam.pose_graph"]),
    ("slam.bundle_adjustment", ["slam.bundle_adjustment"]),
    ("slam.keyframes", ["slam.keyframes"]),
    ("slam.checkpoint", ["slam.checkpoint"]),
    ("slam.slam", ["slam.slam"]),
    ("slam.batched_fusion", ["slam.batched_fusion"]),
    ("slam.pipeline", ["slam.pipeline"]),
    ("spatial.convex", ["spatial.convex"]),
    ("spatial.space_region", ["spatial.space_region"]),
    ("utils.graph", ["utils.graph"]),
    ("utils.mds", ["utils.mds"]),
    ("utils.io", ["utils.io"]),
    ("utils.colormap", ["utils.colormap"]),
    ("utils.timer", ["utils.timer"]),
    ("utils.roofline", ["utils.roofline"]),
    ("utils.honest_timing", ["utils.honest_timing"]),
    ("utils.profiling", ["utils.profiling"]),
    ("utils.ply_io", ["utils.ply_io"]),
    ("native", ["native"]),
    ("viz.interactive", ["viz.interactive"]),
    ("viz.offline", ["viz.offline"]),
    ("viz.live", ["viz.live"]),
    ("parallel.sharded", ["parallel.sharded"]),
    ("parallel.sharded_fusion", ["parallel.sharded_fusion"]),
    ("parallel.sharded_warp", ["parallel.sharded_warp"]),
    ("parallel.distributed", ["parallel.distributed"]),
]

# Names a later slice ports (ROADMAP.md Queue 1): none are left.
LATER = {}
# JAX modules with no counterpart, and why.
NO_COUNTERPART = {
    "core.vma": "types the varying mesh axes of JAX's checked shard_map programs (pcast of "
                "constants before they meet sharded values); a rank's code in PyTorch is plain "
                "per-rank tensors with no such types",
}
# The Pallas calls themselves: their counterparts are the kernel wrappers,
# which take the kernels' augmented rows (``fused_nn.fused_rows``,
# ``fused_knn.knn_full_rows``).
RENAMED = {"nn1_pallas": "fused_rows", "knn_pallas": "knn_full_rows"}
# Parameters removed by design: ``interpret`` (Pallas only); the
# ``coalesced`` switches and FusionConfig.coalesced_gathers (the gather
# kernel always runs on the card); knn_pruned's round knobs (no caller
# sets them).
DROPPED_PARAMS = {"interpret", "coalesced", "coalesced_gathers"}
DROPPED_BY_NAME = {"knn_pruned": {"init_radius", "max_rounds"}}
# JAX's PRNG key is a torch.Generator in the port.
RENAMED_PARAMS = {"key": "generator"}


def _default(d):
    """A parameter default comparable across packages: dtypes by name,
    dataclass configs by their fields (JAX's dropped fields left out)."""
    if d is inspect.Parameter.empty:
        return d
    if dataclasses.is_dataclass(d):
        return (type(d).__name__, {k: v for k, v in dataclasses.asdict(d).items()
                                   if k not in DROPPED_PARAMS})
    if isinstance(d, (type, torch.dtype)) or type(d).__module__.startswith(("jax", "numpy")):
        return str(getattr(d, "__name__", d)).split(".")[-1]
    return d


def _params(fn, drop=()):
    out = []
    for p in inspect.signature(fn).parameters.values():
        if p.name in DROPPED_PARAMS or p.name in drop:
            continue
        out.append((RENAMED_PARAMS.get(p.name, p.name), p.kind, _default(p.default)))
    return out


def _check_signature(label, jfn, tfn, drop=()):
    jp, tp = _params(jfn, drop), _params(tfn)
    assert tp[: len(jp)] == jp, f"{label}: {jp} vs {tp}"
    extra = [p for p in inspect.signature(tfn).parameters.values()][len(jp):]
    assert all(p.default is not inspect.Parameter.empty for p in extra), f"{label}: {extra}"


def _public(module):
    for name, obj in vars(module).items():
        if name.startswith("_") or not callable(obj):
            continue
        if getattr(obj, "__module__", None) == module.__name__:
            yield name, obj


@pytest.mark.parametrize("jname, tnames", MODULES, ids=[m[0] for m in MODULES])
def test_port_keeps_the_public_surface(jname, tnames):
    jmod = importlib.import_module(f"cilantro_tpu.{jname}")
    tmods = [importlib.import_module(f"cilantro_tpu_torch.{t}") for t in tnames]
    later = LATER.get(jname, set())
    checked = 0
    for name, jobj in _public(jmod):
        if name in later:
            continue
        tname = RENAMED.get(name, name)
        tobj = next((getattr(m, tname) for m in tmods if hasattr(m, tname)), None)
        assert tobj is not None, f"{jname}.{name} has no counterpart"
        checked += 1
        if name in RENAMED:
            continue
        if inspect.isclass(jobj):
            if dataclasses.is_dataclass(jobj):
                jf = [f.name for f in dataclasses.fields(jobj) if f.name not in DROPPED_PARAMS]
                tf = [f.name for f in dataclasses.fields(tobj)]
                assert tf[: len(jf)] == jf, f"{jname}.{name}: {jf} vs {tf}"
            for attr, member in vars(jobj).items():
                if attr.startswith("_") or attr in DROPPED_PARAMS or f"{name}.{attr}" in later:
                    continue
                assert hasattr(tobj, attr), f"{jname}.{name}.{attr} has no counterpart"
                tmember = inspect.getattr_static(tobj, attr)
                if isinstance(member, staticmethod) or inspect.isfunction(member):
                    _check_signature(f"{jname}.{name}.{attr}", getattr(jobj, attr), getattr(tobj, attr))
                else:
                    assert type(tmember) is type(member), f"{jname}.{name}.{attr}"
            continue
        _check_signature(f"{jname}.{name}", jobj, tobj, DROPPED_BY_NAME.get(name, ()))
    assert checked > 0


@pytest.mark.parametrize("jname", sorted(NO_COUNTERPART))
def test_modules_without_counterpart(jname):
    """Every JAX module is ported but those recorded here with a reason;
    those have no module of their name in the port."""
    import importlib.util

    assert NO_COUNTERPART[jname]
    assert importlib.util.find_spec(f"cilantro_tpu.{jname}") is not None
    assert importlib.util.find_spec(f"cilantro_tpu_torch.{jname}") is None


def test_slam_package_exports():
    """``cilantro_tpu_torch.slam`` re-exports what JAX's ``slam`` exports,
    the sharded BA included."""
    import cilantro_tpu.slam as jslam
    import cilantro_tpu_torch.slam as tslam

    not_ported = set()
    jnames = {n for n in dir(jslam) if not n.startswith("_") and callable(getattr(jslam, n))}
    tnames = {n for n in dir(tslam) if not n.startswith("_") and callable(getattr(tslam, n))}
    assert jnames - not_ported <= tnames, sorted(jnames - not_ported - tnames)
    for name in ("run_slam", "SlamConfig", "SlamResult", "integrate_sequence", "optimize_pose_graph",
                 "pose_error", "bundle_adjust", "Keyframe", "KeyframeGraph", "detect_loop_closures",
                 "relative_pose", "spawn_keyframe", "FusionCheckpoint", "save_checkpoint",
                 "load_checkpoint", "synthetic_panorama_sequence", "make_pipeline_mesh",
                 "run_fusion_sequence_pipelined", "BatchedFusionMetrics", "batched_fusion_step",
                 "batched_integrate", "batched_seed_localize_target", "run_batched_fusion_sequences",
                 "stack_maps", "unstack_maps", "bundle_adjust_sharded"):
        assert name in tnames, name


# The packages whose ``__init__`` re-exports JAX's names.
PACKAGES = ("core", "neighbors", "correspondence", "clustering", "model_estimation", "spatial", "utils", "viz",
            "parallel")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_reexports(pkg):
    """``cilantro_tpu_torch.<pkg>`` re-exports every public name of JAX's
    ``cilantro_tpu.<pkg>`` (the functions, classes and submodules it
    imports by name), each the port's own counterpart."""
    jpkg = importlib.import_module(f"cilantro_tpu.{pkg}")
    tpkg = importlib.import_module(f"cilantro_tpu_torch.{pkg}")
    jnames = {n for n in vars(jpkg) if not n.startswith("_") and callable(getattr(jpkg, n))}
    jnames |= {n for n in ("pair_evaluators", "profiling") if hasattr(jpkg, n)}
    missing = jnames - set(vars(tpkg))
    assert not missing, sorted(missing)
    for name in jnames:
        obj = getattr(tpkg, name)
        assert getattr(obj, "__module__", getattr(obj, "__name__", "")).startswith("cilantro_tpu_torch"), name


def test_entry_points_keep_jax_signatures():
    """``cilantro_tpu_torch.entry`` has both driver entry points of the JAX
    package's ``__graft_entry__.py``: ``entry`` and ``dryrun_multichip``
    with JAX's parameters, then the keyword-only ``device``."""
    import __graft_entry__ as jentry
    from cilantro_tpu_torch import entry as tentry

    for name in ("entry", "dryrun_multichip"):
        _check_signature(f"entry.{name}", getattr(jentry, name), getattr(tentry, name))
        extra = list(inspect.signature(getattr(tentry, name)).parameters.values())[
            len(inspect.signature(getattr(jentry, name)).parameters):]
        assert [(p.name, p.default) for p in extra] == [("device", "cuda")], name
    device = inspect.signature(tentry.dryrun_multichip).parameters["device"]
    assert device.kind is inspect.Parameter.KEYWORD_ONLY


def test_every_example_has_a_module():
    """Each ``examples/<name>.py`` has ``cilantro_tpu_torch/examples/<name>.py``
    with a ``main(argv=None)``."""
    from pathlib import Path

    names = sorted(p.stem for p in (Path(__file__).resolve().parents[1] / "examples").glob("*.py"))
    assert len(names) == 17
    for name in names:
        mod = importlib.import_module(f"cilantro_tpu_torch.examples.{name}")
        params = list(inspect.signature(mod.main).parameters.values())
        assert [(p.name, p.default) for p in params] == [("argv", None)], name


# The members Queue 3 found missing, against JAX's behaviour.


def _transform_pair(rng, batch=()):
    from cilantro_tpu.core import transforms as jt
    from cilantro_tpu_torch.core import transforms as tt

    omega = rng.standard_normal(batch + (3,)).astype(np.float32)
    lin = np.asarray(jt.axis_angle_to_rotation(jnp.asarray(omega)))
    t = rng.standard_normal(batch + (3,)).astype(np.float32)
    return (jt.Transform(jnp.asarray(lin), jnp.asarray(t)),
            tt.Transform(torch.as_tensor(lin), torch.as_tensor(t)))


@pytest.mark.parametrize("batch", [(), (5,)])
@pytest.mark.parametrize("rigid", [True, False])
def test_transform_members_match_jax(batch, rigid):
    from cilantro_tpu.core import transforms as jt
    from cilantro_tpu_torch.core import transforms as tt

    rng = np.random.default_rng(4)
    (ja, ta), (jb, tb) = _transform_pair(rng, batch), _transform_pair(rng, batch)
    assert tuple(ta.batch_shape) == tuple(ja.batch_shape) == batch
    ji, ti = ja.inverse(rigid=rigid), ta.inverse(rigid=rigid)
    np.testing.assert_allclose(ti.linear.numpy(), np.asarray(ji.linear), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ti.translation.numpy(), np.asarray(ji.translation), rtol=0, atol=1e-5)
    jc, tc = ja @ jb, ta @ tb
    np.testing.assert_allclose(tc.linear.numpy(), np.asarray(jc.linear), rtol=0, atol=1e-6)
    pts = rng.standard_normal(batch + (3,) if batch else (7, 3)).astype(np.float32)
    nrm = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    jp, jn = jt.transform_points_normals(ja, jnp.asarray(pts), jnp.asarray(nrm), rigid=rigid)
    tp, tn = tt.transform_points_normals(ta, torch.as_tensor(pts), torch.as_tensor(nrm), rigid=rigid)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=0, atol=1e-5)
    assert tt.identity(device="cpu").inverse().linear.shape == (3, 3)


def test_rgbd_members_match_jax():
    from cilantro_tpu.core import rgbd as jr
    from cilantro_tpu_torch.core import rgbd as tr

    jk, tk = jr.CameraIntrinsics.make(131.25, 130.0, 79.5, 59.5), tr.CameraIntrinsics.make(131.25, 130.0, 79.5, 59.5)
    np.testing.assert_array_equal(tk.matrix(device="cpu").numpy(), np.asarray(jk.matrix()))
    raw = np.random.default_rng(5).integers(0, 6000, (12, 16)).astype(np.uint16)
    for max_depth in (None, 4.0):
        np.testing.assert_array_equal(
            tr.depth_to_metric(torch.as_tensor(raw.astype(np.int32)), max_depth=max_depth).numpy(),
            np.asarray(jr.depth_to_metric(jnp.asarray(raw), max_depth=max_depth)))
    depth = jr.depth_to_metric(jnp.asarray(raw))
    colors = np.random.default_rng(6).random((12, 16, 3)).astype(np.float32)
    for normals in (False, True):
        jc = jr.rgbd_to_cloud(depth, jnp.asarray(colors), jk, compute_normals=normals)
        tc = tr.rgbd_to_cloud(torch.as_tensor(np.asarray(depth)), torch.as_tensor(colors), tk,
                              compute_normals=normals)
        assert (tc.normals is None) == (jc.normals is None) == (not normals)
        np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
        np.testing.assert_allclose(tc.points.numpy(), np.asarray(jc.points), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(tc.colors.numpy(), np.asarray(jc.colors))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_radial_weights_dtype_and_splat_layers(dtype):
    import jax

    from cilantro_tpu.core.rgbd import CameraIntrinsics as JK
    from cilantro_tpu.slam import fusion as jf
    from cilantro_tpu_torch.core.rgbd import CameraIntrinsics as TK
    from cilantro_tpu_torch.slam import fusion as tf_
    from cilantro_tpu_torch.slam.splat_fusion import SplatMap

    jk, tk = JK.make(52.5, 52.5, 31.5, 23.5), TK.make(52.5, 52.5, 31.5, 23.5)
    got = tf_.radial_weights(24, 32, tk, dtype=getattr(torch, dtype), device="cpu")
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32" or jax.config.jax_enable_x64:
        want = jf.radial_weights(24, 32, jk, dtype=getattr(jnp, dtype))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-7, atol=0)
    else:  # JAX without x64 computes float64 requests in float32
        np.testing.assert_allclose(got.numpy(), tf_.radial_weights(24, 32, tk, device="cpu").numpy(),
                                   rtol=1e-6, atol=0)
    rows = torch.zeros((2, 3, 4, 5))
    assert SplatMap(rows=rows, pose=None).layers == 2
