"""The port's cloud examples on ``--device cpu`` at small sizes, each held
to its planted truth: kNN normals, robust normals, RANSAC and clustering,
spectral clustering and components, mean shift, the non-rigid warp and
the two HTML viewers (one torch thread, ``torch_examples_run``).

The synthetic cloud is the examples' height field (``--points``; 120,000
by default, a few thousand here). Where the JAX script draws from
``jax.random`` (``robust_normals``, ``ransac_and_clustering``,
``spectral_and_components``) the port draws from a ``torch.Generator``:
only the truth is held, not JAX's printed numbers. The non-rigid warp's
median error is held below half its 20 mm bend at 2,000 points."""

import pytest

from torch_examples_run import line, numbers, one_torch_thread, run_port  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_normals_and_downsampling_recover_the_surface_normals():
    out = run_port("normals_and_downsampling", "--points", "4000")
    assert line(out, "4000 points")
    assert 0 < numbers(line(out, "downsample @1cm:"))[1] <= 4000
    assert numbers(line(out, "kNN normals on"))[0] == 4000
    assert numbers(line(out, "|dot| vs the input's stored normals"))[-1] > 0.99


def test_robust_normals_beat_the_outliers():
    out = run_port("robust_normals")
    plain, robust = numbers(line(out, "clean-point normal error:"))
    assert robust < 2.0 and robust < plain
    assert line(out, "chi-square gate:") == "chi-square gate: inlier query valid=True, outlier query valid=False"


def test_ransac_and_clustering_find_the_planted_truth():
    out = run_port("ransac_and_clustering", "--points", "4000")
    assert line(out, "4000 points")
    plane = numbers(line(out, "RANSAC plane:"))
    assert abs(plane[2]) > 0.95 and abs(plane[3]) < 0.05 and plane[4] > 0.3 * 4000  # n ≈ ±z, d ≈ 0
    rot, t, inliers, total = numbers(line(out, "RANSAC transform:"))
    assert rot < 1e-3 and t < 1e-3 and inliers == 1500 and total == 2000
    assert 1 <= numbers(line(out, "k-means:"))[0] <= 100
    segments, _, largest = numbers(line(out, "connected components:"))
    assert segments == 1 and largest == 4000  # one smooth patch, 2 cm gate


def test_spectral_and_components_recover_the_rings():
    out = run_port("spectral_and_components", "--points", "40000")
    for kind in ("unnormalized", "normalized", "random_walk"):
        est, k, purity, total = numbers(line(out, f"spectral [{kind:12s}]"))[-4:]
        assert purity == total == 600, kind
        assert est >= 3, kind  # the reference heuristic's eigengap (JAX prints 6 here too)
    n, segments, _, largest = numbers(line(out, "connected components ("))[:4]
    assert n == 5000 and segments == 1 and largest >= 0.99 * n  # one smooth patch; a stray point may lack a neighbour within 2 cm


def test_mean_shift_finds_the_four_blobs():
    out = run_port("mean_shift")
    for kernel in ("flat", "gaussian"):
        modes, true, err, purity, total = numbers(line(out, f"mean shift [{kernel:8s}]"))
        assert modes == true == 4 and err < 50 and purity == total == 1200, kernel
    assert numbers(line(out, "mean shift [capped  ]"))[:2] == [4, 4]


def test_non_rigid_icp_recovers_the_bend():
    out = run_port("non_rigid_icp", "--points", "2000")
    assert line(out, "2000 points")
    assert numbers(line(out, "median error"))[0] < 10.0


def test_viewers_write_their_html(tmp_path):
    out = run_port("image_viewer", "--points", "4000", "--out", str(tmp_path))
    lo, hi = numbers(line(out, "rendered"))[-2:]
    assert 0 < lo < hi
    for name in ("image_viewer_rgb.html", "image_viewer_depth.html"):
        html = (tmp_path / name).read_text()
        assert "data:image/png;base64," in html and len(html) > 10_000, name
    out = run_port("visualizer", "--points", "4000", "--out", str(tmp_path))
    assert line(out, "4000 points from")
    for window in (1, 2):
        assert line(out, f"window {window} ->").endswith(f"visualizer_window{window}.html")
        assert (tmp_path / f"visualizer_window{window}.html").stat().st_size > 10_000
