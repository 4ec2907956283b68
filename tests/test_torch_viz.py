"""The port's interactive and live visualization against the JAX package
on the CPU: the exported scene JSON of each renderable and of
``Visualizer`` (inputs given to the port as tensors, to JAX as numpy),
``ImageViewer``'s page, and ``LiveMapViewer`` on the 48×64, 6-frame pool
run of ``tests/test_viz_interactive.py``. The offline renders are in
``tests/test_torch_viz_offline.py``."""

import base64
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilantro_tpu import viz as jviz
from cilantro_tpu.core import containers as jcont
from cilantro_tpu.core import transforms as jtf
from cilantro_tpu.core.rgbd import CameraIntrinsics as JK
from cilantro_tpu.correspondence.search import Correspondences as JCorr
from cilantro_tpu_torch import interop
from cilantro_tpu_torch import viz as tviz
from cilantro_tpu_torch.core import containers as tcont
from cilantro_tpu_torch.core import transforms as ttf
from cilantro_tpu_torch.core.rgbd import CameraIntrinsics as TK
from cilantro_tpu_torch.correspondence.search import Correspondences as TCorr


def _scene(html: str) -> dict:
    m = re.search(r"const SCENE = (\{.*?\});\n", html, re.S)
    assert m, "scene JSON not embedded"
    return json.loads(m.group(1))


def _data(seed=0, n=60):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    col = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    vals = rng.standard_normal(n).astype(np.float32)
    return pts, nrm, col, vals


def _rigid(seed):
    rng = np.random.default_rng(seed)
    lin = np.array(jtf.axis_angle_to_rotation(jnp.asarray(rng.standard_normal(3).astype(np.float32))))
    t = rng.standard_normal(3).astype(np.float32)
    return jtf.Transform(jnp.asarray(lin), jnp.asarray(t)), ttf.Transform(torch.as_tensor(lin), torch.as_tensor(t))


def _scenes(pkg, T, mesh_verts, mesh_faces):
    """Each renderable kind, built by ``pkg`` from inputs ``T`` converts
    (numpy for JAX, tensors for the port), as ``(name, renderable)``."""
    pts, nrm, col, vals = _data()
    rp = pkg.RenderingProperties
    jt, tt = _rigid(1)
    tf = tt if T is torch.as_tensor else jt
    valid = np.arange(len(pts)) % 3 != 0
    if T is torch.as_tensor:
        cloud = tcont.PointCloud(points=T(pts), normals=T(nrm), colors=T(col), valid=T(valid))
        corr = TCorr(dst_idx=T(np.arange(60)[::-1].copy().astype(np.int32)), distances=T(vals),
                     weights=T(np.ones(60, np.float32)), mask=T(valid))
        k = TK.make(500.0, 500.0, 320.0, 240.0)
    else:
        cloud = jcont.PointCloud(points=pts, normals=nrm, colors=col, valid=valid)
        corr = JCorr(dst_idx=np.arange(60)[::-1].astype(np.int32), distances=vals,
                     weights=np.ones(60, np.float32), mask=valid)
        k = JK.make(500.0, 500.0, 320.0, 240.0)
    return [
        ("cloud_rgb", pkg.PointCloudRenderable((T(pts), T(nrm), T(col)), rp(point_size=3.0, draw_normals=True))),
        ("cloud_masked", pkg.PointCloudRenderable(cloud, rp(line_density_fraction=0.3))),
        ("cloud_values", pkg.PointCloudRenderable(T(pts)).set_point_values(T(vals))),
        ("cloud_range", pkg.PointCloudRenderable(T(pts), rp(colormap_type="blue2red").set_scalar_values_range(
            -1.0, 0.5)).set_point_values(T(vals))),
        ("cloud_uniform", pkg.PointCloudRenderable(T(pts), rp().set_point_color(0.1, 0.2, 0.3))),
        ("corr", pkg.PointCorrespondencesRenderable(T(pts), T(pts + 0.1), corr, rp(line_width=2.0))),
        ("corr_positional", pkg.PointCorrespondencesRenderable(T(pts[:20]), T(pts[:30] * 2))),
        ("frame", pkg.CoordinateFrameRenderable(tf, scale=0.5)),
        ("frame_matrix", pkg.CoordinateFrameRenderable(T(np.eye(4, dtype=np.float32)[:3]), scale=0.2)),
        ("frustum", pkg.CameraFrustumRenderable(640, 480, k, pose=tf, scale=0.1, rp=rp(opacity=0.5))),
        ("mesh", pkg.TriangleMeshRenderable(T(mesh_verts), T(mesh_faces)).set_vertex_values(T(vals[:4]))),
        ("mesh_faces", pkg.TriangleMeshRenderable(T(mesh_verts), T(mesh_faces), rp(
            use_face_colors=True, draw_wireframe=True)).set_face_colors(T(col[:4]))),
        ("mesh_face_values", pkg.TriangleMeshRenderable(T(mesh_verts), T(mesh_faces), rp(
            use_face_colors=True)).set_face_values(T(vals[:4]))),
        ("mesh_smooth", pkg.TriangleMeshRenderable(T(mesh_verts), T(mesh_faces), rp(
            use_face_normals=False)).set_vertex_normals(T(nrm[:4])).set_vertex_colors(T(col[:4]))),
        ("text", pkg.TextRenderable("</script>label", T(pts[0]), rp(font_size=11.0))),
    ]


MESH_VERTS = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
MESH_FACES = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], np.int64)


def test_each_renderable_exports_jax_primitives():
    jr = _scenes(jviz, np.asarray, MESH_VERTS, MESH_FACES)
    tr = _scenes(tviz, torch.as_tensor, MESH_VERTS, MESH_FACES)
    for (name, a), (_, b) in zip(jr, tr):
        assert json.dumps(b.primitives(), default=float) == json.dumps(a.primitives(), default=float), name
        ba, bb = a.bounds(), b.bounds()
        assert (ba is None) == (bb is None), name
        if ba is not None:
            np.testing.assert_array_equal(bb, ba)


def _visualizer(pkg, T):
    v = pkg.Visualizer("g2 scene")
    for name, r in _scenes(pkg, T, MESH_VERTS, MESH_FACES):
        v.add_object(name, r)
    v.toggle_visibility("cloud_uniform").set_clear_color(0.2, 0.3, 0.4)
    return v


def test_visualizer_scene_and_page_equal_jax(tmp_path):
    jv, tv = _visualizer(jviz, np.asarray), _visualizer(tviz, torch.as_tensor)
    assert tv._scene_json() == jv._scene_json()
    for v in (jv, tv):
        v.set_camera_pose([0, 0, -3], [0, 0, 0]).set_perspective_projection(640, 480, 500, 500, 320, 240)
    assert tv._scene_json() == jv._scene_json()
    jv.set_orthographic_projection(2.0).remove("text")
    tv.set_orthographic_projection(2.0).remove("text")
    pj, pt = str(tmp_path / "j" / "s.html"), str(tmp_path / "t" / "s.html")
    assert jv.export_html(pj) == pj and tv.export_html(pt) == pt
    html = open(pt).read()
    assert html == open(pj).read()
    scene = _scene(html)
    assert scene["title"] == "g2 scene" and scene["projection"]["ortho"]
    assert tv.get_object_names() == jv.get_object_names() and not tv.get_visibility("cloud_uniform")


def test_image_viewer_exports_as_jax(tmp_path):
    img = np.linspace(0, 1, 48, dtype=np.float32).reshape(4, 4, 3)
    for image in (img, img[..., 0], (img * 255).astype(np.uint8)):
        pj, pt = str(tmp_path / "j.html"), str(tmp_path / "t.html")
        jviz.ImageViewer("depth").set_image(image).export_html(pj)
        tviz.ImageViewer("depth").set_image(torch.as_tensor(image)).export_html(pt)
        assert open(pt).read() == open(pj).read()
    with pytest.raises(RuntimeError, match="set_image"):
        tviz.ImageViewer().export_html(str(tmp_path / "none.html"))


def _live_run():
    """The 48×64, 6-frame pool run of ``tests/test_viz_interactive.py``."""
    from cilantro_tpu.core.rgbd import CameraIntrinsics
    from cilantro_tpu.slam import synthetic_sequence

    h, w = 48, 64
    k = CameraIntrinsics.make(w * 525 / 640, w * 525 / 640, (w - 1) / 2, (h - 1) / 2)
    depths, _ = synthetic_sequence(6, h, w, k, seed=2)
    return depths, k, h, w


def test_live_map_viewer_snapshots_match_jax(tmp_path):
    """JAX's driver with JAX's viewer; at each snapshot the port's viewer
    on the same map and pose writes JAX's page. Then the port's own driver
    with the port's viewer snapshots at the same frames, each page with
    the subsampled valid points of the map it was given."""
    from cilantro_tpu.slam import run_fusion_sequence as jrun
    from cilantro_tpu_torch.core.rgbd import CameraIntrinsics as K2
    from cilantro_tpu_torch.slam import run_fusion_sequence as trun

    depths, k, h, w = _live_run()
    jpath, tpath = str(tmp_path / "j.html"), str(tmp_path / "t.html")
    jview = jviz.LiveMapViewer(jpath, every=2, subsample=500)
    tview = tviz.LiveMapViewer(tpath, every=2, subsample=500)
    compared = []

    def both(fi, fmap, pose):
        jview(fi, fmap, pose)
        tmap = interop.fusion_map_from_numpy(np.asarray(fmap.data), device="cpu")
        tpose = interop.transform_from_numpy(np.array(pose.linear), np.array(pose.translation), device="cpu")
        tview(fi, tmap, tpose)
        if fi % 2 == 0:
            assert open(tpath).read() == open(jpath).read()
            compared.append(fi)

    jrun(depths, k, map_capacity=4 * h * w, on_frame=both)
    assert compared == [2, 4] and tview.snapshots == jview.snapshots == 2

    own = str(tmp_path / "own.html")
    viewer = tviz.LiveMapViewer(own, every=2, subsample=500)
    seen = []

    def hook(fi, fmap, pose):
        viewer(fi, fmap, pose)
        if fi % 2 == 0:
            live = fmap.points[fmap.valid]
            step = max(len(live) // 500, 1) if len(live) > 500 else 1
            html = open(own).read()
            assert "http-equiv" in html and f"fusion live (frame {fi})" in html
            cloud = next(p for p in _scene(html)["objects"] if p["name"] == "map" and p["kind"] == "points")
            got = np.frombuffer(base64.b64decode(cloud["pos"]), np.float32).reshape(-1, 3)
            np.testing.assert_array_equal(got, live[::step].numpy())
            seen.append(fi)

    kk = K2.make(k.fx, k.fy, k.cx, k.cy)
    trun(depths, kk, map_capacity=4 * h * w, on_frame=hook, device="cpu")
    assert seen == [2, 4] and viewer.snapshots == 2
    assert not os.path.exists(own + ".tmp")
