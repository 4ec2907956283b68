"""The port's point-sharded warp fields (``cilantro_tpu_torch/parallel/
sharded_warp.py``) on a gloo group of 4 subprocess ranks against the JAX
package's sharded solves on a (4, 1) mesh of the conftest's virtual CPU
devices, and against the port's single-device solves, at
``tests/test_sharded_warp.py``'s problems (2,048 points of a bent surface,
its control nodes, 4 anchors, 6 arcs, CG).

Both packages solve on JAX's graph (carried across by
``interop.deformation_graph_from_numpy``). Tolerances: warped points
within 1e-4 m of JAX's sharded solve and of the port's single-device solve
at the median (1e-3 m at the max), the bend recovered (JAX's test's 1 cm
median), and the node transforms bit-identical across ranks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cilantro_tpu.parallel import make_mesh, sharded_estimate_warp_field, sharded_icp_warp_field
from cilantro_tpu.registration import build_deformation_graph, warp_points
from torch_parallel_ranks import Ranks
from torch_parallel_worker import WARP_EST_KW, WARP_ICP_KW, warp_case

WORLD = 4


@pytest.fixture(scope="module")
def case():
    src, dst, nodes = warp_case()
    graph = build_deformation_graph(jnp.asarray(src), jnp.asarray(nodes), k_anchors=4, k_arcs=6)
    return src, dst, graph


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    src, dst, graph = case
    inputs = {"src": src, "dst": dst}
    for f in dataclasses.fields(graph):
        v = getattr(graph, f.name)
        if v is not None:
            inputs[f"graph_{f.name}"] = np.asarray(v)
    return Ranks("warp", WORLD, tmp_path_factory.mktemp("warp"), inputs)


def _close(a, b, label):
    err = np.linalg.norm(a - b, axis=1)
    assert np.median(err) < 1e-4 and err.max() < 1e-3, (label, np.median(err), err.max())


@pytest.mark.parametrize("route", ["estimate", "icp"])
def test_sharded_warp_matches_jax_and_one_device(case, ranks, route):
    src, dst, graph = case
    mesh = make_mesh(WORLD, 1, devices=jax.devices()[:WORLD])
    if route == "estimate":
        tf, _, _ = sharded_estimate_warp_field(graph, jnp.asarray(src), jnp.asarray(dst), None,
                                               jnp.ones(len(src), jnp.float32), mesh=mesh, **WARP_EST_KW)
    else:
        tf, _, _ = sharded_icp_warp_field(graph, jnp.asarray(src), jnp.asarray(dst), mesh=mesh, **WARP_ICP_KW)
    jwarped = np.asarray(warp_points(graph, tf, jnp.asarray(src)))
    res = ranks.results()
    warped = res[0][route]["warped"]
    _close(warped, jwarped, "JAX sharded")
    _close(warped, res[0][f"{route}_single"]["warped"], "port one device")
    assert np.median(np.linalg.norm(warped - dst, axis=1)) < 0.01


def test_sharded_direct_route_matches_one_device(ranks):
    """The direct solver on the sharded graph: the point pairs' blocks
    scattered on each rank and reduced, the arcs' added once in a fixed
    order; two GN steps within the same bounds of the port's one-device
    direct solve (on its sorted caches)."""
    res = ranks.results()
    _close(res[0]["direct"]["warped"], res[0]["direct_single"]["warped"], "port one device, direct")


def test_node_state_is_identical_across_ranks(ranks):
    res = ranks.results()
    for route in ("estimate", "direct", "icp"):
        for other in res[1:]:
            for key in ("linear", "translation", "warped"):
                assert np.array_equal(other[route][key], res[0][route][key]), (route, key)
    assert all(r["icp"]["iterations"] == res[0]["icp"]["iterations"] for r in res)
