"""Plain reference of pool fusion: frame-to-model projective ICP (the
symmetric metric, one Gauss-Newton step an iteration) against the model
rendered at the previous pose, then fuse / augment / carve of the frame
into a fixed-capacity pool of ``(C, 16)`` rows ``[point | normal | color |
confidence | valid | 0...]``. B streams advance one frame a step; each
stream's ICP is its own loop, which stops at its own tolerance; the
z-buffer keys are taken over all streams' rows at once.

Eager PyTorch in float32 (float64 for the rounding probe); every
threshold comes from the configuration's ``settings``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .geometry import (
    Intrinsics,
    Rigid,
    axis_angle_to_rotation,
    compose,
    depth_to_points_normals,
    ein,
    identity,
    inverse,
    project,
    real,
    reproject,
    skew3,
    zbuffer,
)

WIDTH, CONF, VALID = 16, 9, 10

DEFAULTS = dict(
    fuse_depth=0.01, occlusion_depth=0.025, fuse_normal_cos=0.25881904,
    augment_normal_cos=-0.25881904, carve_view_cos=0.70710678, radial_sigma_px=120.0,
    icp_iterations=6, icp_convergence_tol=5e-4, icp_max_corr_dist_sq=0.01,
    icp_point_weight=0.0, icp_plane_weight=1.0, icp_gn_iterations=1, localize_stride=1,
)


def _pack(rows, ok, cam: Rigid):
    """Camera-frame localize target ``[point | normal | flag | 0]``."""
    rows = torch.where(ok[..., None], rows, 0.0)
    flag = ok.to(real())[..., None]
    packed = torch.cat([cam.apply(rows[..., 0:3]), cam.rotate(rows[..., 3:6]), flag,
                        torch.zeros_like(flag)], dim=-1)
    return torch.where(ok[..., None], packed, 0.0)


def _gather(data, idx):
    """Rows ``data[b, idx[b]]``, indices clamped into the pool."""
    return torch.gather(data, 1, idx.clamp(0, data.shape[1] - 1).long()[..., None]
                        .expand(-1, -1, data.shape[2]))


def _two_sided(step):
    """``Ra · T(cos θ · t) · Ra``, ``θ = atan‖ω‖``."""
    omega, t = step[:3], step[3:]
    na = torch.linalg.vector_norm(omega)
    theta = torch.atan(na)
    scale = torch.where(na > 1e-12, theta / torch.clamp(na, min=1e-12), 1.0)
    half = axis_angle_to_rotation(omega * scale)
    zero = torch.zeros_like(t)
    eye = torch.eye(3, dtype=step.dtype, device=step.device)
    return compose(Rigid(half, zero), compose(Rigid(eye, torch.cos(theta) * t), Rigid(half, zero)))


def _gn_symmetric(src, dst, src_n, dst_n, w_pp, w_pl):
    """One Gauss-Newton step of the symmetric metric in centred
    coordinates, as a rigid transform of ``src``."""
    wsum = torch.clamp(torch.sum(w_pp + w_pl), min=1e-12)
    mu_s = ein("n,ni->i", w_pp + w_pl, src) / wsum
    mu_d = ein("n,ni->i", w_pp + w_pl, dst) / wsum
    s, d = src - mu_s, dst - mu_d
    n = dst_n + src_n  # the GN transform starts at the identity
    p = s + d
    j_pl = torch.cat([torch.linalg.cross(p, n, dim=-1), n], dim=1)
    r_pl = ein("ni,ni->n", n, s - d)
    jtj = ein("n,ni,nj->ij", w_pl, j_pl, j_pl)
    jtr = -ein("n,ni,n->i", w_pl, j_pl, r_pl)
    sk = skew3(p)
    r_pp = s - d
    jtj_ww = ein("n,nki,nkj->ij", w_pp, sk, sk)
    jtj_wt = ein("n,nij->ij", w_pp, sk)
    jtj_tt = torch.sum(w_pp) * torch.eye(3, dtype=s.dtype, device=s.device)
    block = torch.cat([torch.cat([jtj_ww, jtj_wt], 1), torch.cat([jtj_wt.T, jtj_tt], 1)], 0)
    jtr_pp = torch.cat([-ein("n,nki,nk->i", w_pp, -sk, r_pp), -ein("n,ni->i", w_pp, r_pp)])
    jtj, jtr = jtj + block, jtr + jtr_pp
    step = torch.linalg.solve_ex(jtj + 1e-12 * torch.eye(6, dtype=s.dtype, device=s.device),
                                 jtr, check_errors=False)[0]
    eye = torch.eye(3, dtype=s.dtype, device=s.device)
    delta = compose(_two_sided(step), Rigid(eye, torch.zeros_like(mu_s)))
    return compose(Rigid(eye, mu_d), compose(delta, Rigid(eye, -mu_s)))


def icp(src, src_n, src_ok, packed, k: Intrinsics, h, w, cfg) -> Tuple[Rigid, int]:
    """Projective ICP of one stream's frame ``src (N, 3)`` against its
    packed target ``(H·W, 8)``: the camera-frame correction and the
    iterations taken."""
    dev = src.device
    tf = identity(device=dev)
    eye = torch.eye(3, dtype=real(), device=dev)
    it, dn = 0, float("inf")
    while it < cfg["icp_iterations"] and dn >= cfg["icp_convergence_tol"]:
        s = tf.apply(src)
        u, v, z = project(s, k)
        in_img = (z > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        row = packed[torch.where(in_img, v * w + u, -1).clamp(0, packed.shape[0] - 1).long()]
        dst, dst_n = row[:, 0:3], row[:, 3:6]
        diff = dst - s
        ok = in_img & (row[:, 6] > 0.5) & src_ok
        ok = ok & (torch.sum(diff * diff, dim=-1) <= cfg["icp_max_corr_dist_sq"])
        wt = ok.to(real())
        delta = _gn_symmetric(s, dst, tf.rotate(src_n), dst_n, wt * cfg["icp_point_weight"],
                              wt * cfg["icp_plane_weight"])
        tf = reproject(compose(delta, tf))
        dn = float(torch.linalg.vector_norm(delta.linear - eye)
                   + torch.linalg.vector_norm(delta.translation))
        it += 1
    return tf, it


def _radial(h, w, k: Intrinsics, sigma, dev):
    u = (torch.arange(w, dtype=real(), device=dev) - k.cx)[None, :]
    v = (torch.arange(h, dtype=real(), device=dev) - k.cy)[:, None]
    sigma2 = torch.full((), sigma * sigma, dtype=real(), device=dev)
    return torch.exp(-0.5 * (u * u + v * v) / sigma2).reshape(-1)


def integrate(data, pts, nrm, ok, poses: Rigid, k: Intrinsics, h, w, cfg):
    """Fuse / augment / carve each stream's frame ``(B, H·W, 3)`` into its
    pool ``(B, C, 16)`` at its pose. Returns the pools and the next
    localize targets ``(B, H·W, 8)``."""
    bsz, cap, _ = data.shape
    dev = data.device
    cams = inverse(poses).per_stream()
    pst = poses.per_stream()
    valid = data[..., VALID] > 0.5
    imap, mdepth = zbuffer(cams.apply(data[..., 0:3]), valid, k, h, w)
    imap, mdepth = imap.reshape(bsz, -1), mdepth.reshape(bsz, -1)
    m_ok = imap >= 0
    m_idx = torch.where(m_ok, imap, 0)
    mrows = torch.where(m_ok[..., None], _gather(data, imap), 0.0)

    fd = pts[..., 2]
    pix = torch.arange(h * w, dtype=torch.int32, device=dev)
    pu, pv = pix % w, pix // w
    f_ok = ok & (fd > 0) & (pu >= 1) & (pu <= w - 2) & (pv >= 1) & (pv <= h - 2)
    radial = _radial(h, w, k, cfg["radial_sigma_px"], dev)
    m_pts_w, m_nrm_w, c_old = mrows[..., 0:3], mrows[..., 3:6], mrows[..., CONF]
    m_pts_cam, m_nrm_cam = cams.apply(m_pts_w), cams.rotate(m_nrm_w)
    ncos = torch.sum(nrm * m_nrm_cam, dim=-1)
    ddiff = fd - mdepth
    fuse = f_ok & m_ok & (torch.abs(ddiff) < cfg["fuse_depth"]) & (ncos > cfg["fuse_normal_cos"])
    m_img = m_ok.reshape(bsz, h, w)
    nb = (torch.roll(m_img, 1, -2) | torch.roll(m_img, -1, -2) | torch.roll(m_img, 1, -1)
          | torch.roll(m_img, -1, -1)).reshape(bsz, -1)
    augment = ~fuse & f_ok & ((~m_ok & ~nb) | (m_ok & (ncos < cfg["augment_normal_cos"])))
    m_dir = m_pts_cam / torch.clamp(torch.linalg.vector_norm(m_pts_cam, dim=-1, keepdim=True),
                                    min=1e-30)
    view_cos = -torch.sum(m_dir * m_nrm_cam, dim=-1)
    carve = (~fuse & ~augment & f_ok & m_ok & (ddiff > cfg["occlusion_depth"])
             & (view_cos > cfg["carve_view_cos"]))

    pts_w, nrm_w = pst.apply(pts), pst.rotate(nrm)
    wf = (radial / torch.clamp(radial + c_old, min=1e-30))[..., None]
    f_nrm = m_nrm_w * (1.0 - wf) + nrm_w * wf
    f_nrm = f_nrm / torch.clamp(torch.linalg.vector_norm(f_nrm, dim=-1, keepdim=True), min=1e-30)
    one = torch.ones((bsz, h * w, 1), dtype=real(), device=dev)
    tail = torch.zeros((bsz, h * w, WIDTH - CONF - 2), dtype=real(), device=dev)
    zeros3 = torch.zeros_like(pts)
    fuse_rows = torch.cat([m_pts_w * (1.0 - wf) + pts_w * wf, f_nrm,
                           mrows[..., 6:9] * (1.0 - wf) + zeros3 * wf, c_old[..., None] + wf,
                           one, tail], dim=-1)
    aug_rows = torch.cat([pts_w, nrm_w, zeros3, radial[:, None].expand(bsz, -1, 1), one, tail],
                         dim=-1)
    carve_row = torch.zeros((WIDTH,), dtype=real(), device=dev)
    carve_row[0:3] = 1e30

    # Augments append past each pool's highest valid slot.
    rank = torch.cumsum(augment.to(torch.int32), 1).to(torch.int32) - 1
    slots = torch.arange(cap, dtype=torch.int32, device=dev)
    tail_start = torch.max(torch.where(valid, slots, -1), dim=1).values + 1
    aug_slot = tail_start[:, None] + rank
    aug_ok = augment & (aug_slot < cap)
    tgt = torch.where(fuse | carve, m_idx, torch.where(aug_ok, aug_slot.clamp(0, cap - 1), cap))
    rows_out = torch.where(fuse[..., None], fuse_rows,
                           torch.where(carve[..., None], carve_row, aug_rows))
    out = torch.cat([data, data[:, :1]], dim=1)
    out.scatter_(1, tgt.long()[..., None].expand(-1, -1, WIDTH), rows_out)
    post = torch.where(fuse[..., None], fuse_rows, mrows)
    alive = m_ok & ~carve & (post[..., VALID] > 0.5)
    return out[:, :cap], _pack(post, alive, cams)


def seed(pts, nrm, ok, cap: int):
    """Pools seeded with each stream's first frame at the identity."""
    bsz, n, _ = pts.shape
    data = torch.zeros((bsz, cap, WIDTH), dtype=real(), device=pts.device)
    data[..., 0:3] = 1e30
    data[:, :n, 0:3] = torch.where(ok[..., None], pts, 1e30)
    data[:, :n, 3:6] = nrm
    data[:, :n, CONF] = ok.to(real())
    data[:, :n, VALID] = ok.to(real())
    return data


def run(depths: np.ndarray, k: Intrinsics, settings: dict, map_capacity: int, device
        ) -> Tuple[np.ndarray, torch.Tensor, List[List[int]]]:
    """Pool fusion of B streams ``depths (B, F, H, W)``: ``(poses (B, F,
    4, 4) camera-to-world, pools (B, C, 16), ICP iterations a stream a
    frame)``."""
    cfg = dict(DEFAULTS, **settings)
    if cfg.get("reuse_carved_slots") or cfg["icp_gn_iterations"] != 1:
        raise ValueError("the reference appends at the tail and takes one GN step an iteration")
    bsz, nf, h, w = depths.shape
    dev = torch.device(device)
    frames = torch.as_tensor(np.ascontiguousarray(depths, np.float32), device=dev).to(real())
    pts, nrm, ok = depth_to_points_normals(frames[:, 0], k)
    data = seed(pts, nrm, ok, map_capacity)
    poses = identity((bsz,), device=dev)
    cams = inverse(poses).per_stream()
    imap, _ = zbuffer(cams.apply(data[..., 0:3]), data[..., VALID] > 0.5, k, h, w)
    imap = imap.reshape(bsz, -1)
    rows = _gather(data, imap)
    packed = _pack(rows, (imap >= 0) & (rows[..., VALID] > 0.5), cams)
    s = cfg["localize_stride"]
    sub = (torch.arange(0, h, s, device=dev)[:, None] * w
           + torch.arange(0, w, s, device=dev)[None, :]).reshape(-1)
    mats = [poses.matrix()]
    iters = [[0] * bsz]
    for f in range(1, nf):
        pts, nrm, ok = depth_to_points_normals(frames[:, f], k)
        lin, tr, its = [], [], []
        for b in range(bsz):
            delta, it = icp(pts[b, sub], nrm[b, sub], ok[b, sub], packed[b], k, h, w, cfg)
            pb = compose(Rigid(poses.linear[b], poses.translation[b]), delta)
            lin.append(pb.linear)
            tr.append(pb.translation)
            its.append(it)
        poses = Rigid(torch.stack(lin), torch.stack(tr))
        data, packed = integrate(data, pts, nrm, ok, poses, k, h, w, cfg)
        mats.append(poses.matrix())
        iters.append(its)
    out = torch.stack(mats, dim=1).cpu().numpy()
    return out, data, [list(x) for x in zip(*iters)]


def map_cloud(data: torch.Tensor):
    """World points, validity, normals and confidence of one pool ``(C, 16)``."""
    return data[:, 0:3], data[:, VALID] > 0.5, data[:, 3:6], data[:, CONF]
