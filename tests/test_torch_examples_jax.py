"""The port's examples whose JAX scripts are deterministic and cheap, run
beside those scripts on the same inputs (``runpy`` with the same
``sys.argv``; the port's module in-process with ``--device cpu``), their
printed lines compared.

* ``convex_hull``, ``space_regions`` and ``io_and_images`` print the same
  lines: their numbers come from the host hull code, exact set tests and
  exact round trips, and agree to every printed digit.
* ``mds_and_pca``: the same lines but MDS's distance-matrix RMS error,
  float32 noise (2.47e-07 against 1.96e-07) in other summation orders;
  both are held below 1e-5 instead, the other numbers within 1e-5
  relative.
* ``kd_tree`` on the same PLY: the same lines (the unpruned searches
  the port's module asks for are the routes JAX takes on the CPU).
* ``rigid_icp`` on a 4,000-point height field written as a PLY under
  ``tmp_path``: the same TRUE transform, the ESTIMATED transform within
  1e-5 absolute of JAX's (its entries are O(1) and both lie within 2e-7 of
  the truth, where a relative bound on the zero entries would compare
  float32 noise), and both max abs errors below 1e-3.
"""

import numpy as np
import pytest

from cilantro_tpu_torch.examples._common import height_field
from cilantro_tpu_torch.utils.ply_io import write_point_cloud
from torch_examples_run import line, numbers, one_torch_thread, run_jax, run_port  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("name", ["convex_hull", "space_regions", "io_and_images"])
def test_same_lines_as_jax(name):
    assert run_port(name) == run_jax(name)


def test_mds_and_pca_matches_jax():
    port, jax_out = run_port("mds_and_pca"), run_jax("mds_and_pca")
    tp, tj = port.splitlines(), jax_out.splitlines()
    assert len(tp) == len(tj) == 4
    pn, jn = numbers(tp[0]), numbers(tj[0])
    assert pn[:2] == jn[:2] == [2.0, 2.0]  # the dimension picked, the true one
    assert pn[2] < 1e-5 and jn[2] < 1e-5
    for a, b in zip(tp[1:], tj[1:]):
        np.testing.assert_allclose(numbers(a), numbers(b), rtol=1e-5, atol=0)


@pytest.fixture(scope="module")
def small_ply(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cloud") / "height_field.ply")
    pts, nrm, _ = height_field(4000)
    write_point_cloud(path, pts, nrm, None)
    return path


def _matrix(text, title):
    rows = text.split(title, 1)[1].split("]]", 1)[0]
    return np.array(numbers(rows)).reshape(4, 4)


def test_rigid_icp_matches_jax(small_ply):
    port, jax_out = run_port("rigid_icp", small_ply), run_jax("rigid_icp", small_ply)
    assert line(port, "4000 points from") == line(jax_out, "4000 points from")
    true = _matrix(port, "TRUE transform")
    np.testing.assert_array_equal(true, _matrix(jax_out, "TRUE transform"))
    np.testing.assert_allclose(_matrix(port, "ESTIMATED transform"), _matrix(jax_out, "ESTIMATED transform"),
                               rtol=0, atol=1e-5)
    for out in (port, jax_out):
        assert numbers(line(out, "max abs error:"))[0] < 1e-3


def test_kd_tree_matches_jax(small_ply):
    port = run_port("kd_tree", small_ply)
    assert port == run_jax("kd_tree", small_ply)
    assert line(port, "grid backend:").endswith("2000/2000 queries agree with brute force")
