"""Plain reference of surfel-splat fusion: a two-layer surfel image homed
to the current camera and padded by a margin. Each frame: model→frame
projective point-to-plane Gauss-Newton (each iteration projects the
surfels through the estimate and reads the frame at the projected pixel),
then re-homing to the new pose by electing the nearest and the second
nearest surfel that lands on each pixel within a window of ±radius, then
fuse / carve / augment as per-pixel selects.

Eager PyTorch in float32 (float64 for the rounding probe; the election
as a sweep over window offsets); every threshold comes from the
configuration's ``settings``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .geometry import (
    Intrinsics,
    Rigid,
    compose,
    depth_to_points_normals,
    ein,
    f32,
    gn_update,
    identity,
    inverse,
    real,
    reproject,
)

PT, NRM, CONF, VALID, CHANNELS = slice(0, 3), slice(3, 6), 6, 7, 8

DEFAULTS = dict(
    radius=4, margin=16, icp_iterations=6, icp_convergence_tol=5e-4, icp_max_corr_dist_sq=0.01,
    icp_normal_dot_min=0.0, depth_fuse_thresh=0.01, occlusion_thresh=0.025,
    fuse_normal_dot_min=0.2588, max_confidence=100.0, carve_penalty=2.0,
)


def _frame(depth, k: Intrinsics):
    """``(points (3, H, W), normals (3, H, W), valid (H, W))``."""
    h, w = depth.shape
    pts, nrm, ok = depth_to_points_normals(depth, k)
    return (pts.reshape(h, w, 3).permute(2, 0, 1), nrm.reshape(h, w, 3).permute(2, 0, 1),
            ok.reshape(h, w))


def _code(du, dv, r):
    w2 = 2 * r + 1
    ok = (du >= -r) & (du <= r) & (dv >= -r) & (dv <= r)
    return torch.where(ok, (dv + r) * w2 + (du + r), -1).to(torch.int32)


def _project(rows, cw: Rigid, k: Intrinsics, m: int, r: int):
    """Every surfel through ``cw``: ``(camera depth, window code of its
    projected model pixel relative to its home, -1 outside; valid)``."""
    _, _, hm, wm = rows.shape
    x, y, z = rows[:, 0], rows[:, 1], rows[:, 2]
    rl, t = cw.linear, cw.translation
    xc = rl[0, 0] * x + rl[0, 1] * y + rl[0, 2] * z + t[0]
    yc = rl[1, 0] * x + rl[1, 1] * y + rl[1, 2] * z + t[1]
    zc = rl[2, 0] * x + rl[2, 1] * y + rl[2, 2] * z + t[2]
    valid = (rows[:, VALID] > 0.5) & (zc > 1e-6)
    zs = torch.where(valid, zc, 1.0)
    u = (torch.round(xc * k.fx / zs + k.cx) + m).clamp(-(2.0**30), 2.0**30).to(torch.int32)
    v = (torch.round(yc * k.fy / zs + k.cy) + m).clamp(-(2.0**30), 2.0**30).to(torch.int32)
    cols = torch.arange(wm, dtype=torch.int32, device=rows.device)
    rws = torch.arange(hm, dtype=torch.int32, device=rows.device)[:, None]
    return zc, torch.where(valid, _code(u - cols, v - rws, r), -1), valid


def _read(img, code, r):
    """``img (C, H+2R, W+2R)`` read at each pixel's window offset ``code
    (L, H, W)``: ``(L, C, H, W)``, with ``ok`` where the code is in the
    window."""
    w2 = 2 * r + 1
    c, hp, wp = img.shape
    layers, h, w = code.shape
    ok = (code >= 0) & (code < w2 * w2)
    oc = torch.where(ok, code, r * w2 + r)
    ys = torch.arange(h, device=code.device)[:, None] + r + (oc // w2 - r)
    xs = torch.arange(w, device=code.device)[None, :] + r + (oc % w2 - r)
    flat = img.reshape(c, hp * wp)
    out = flat[:, (ys * wp + xs).reshape(-1)].reshape(c, layers, h, w).transpose(0, 1)
    return out, ok


def localize(rows, fpt, fnm, fok, guess: Rigid, k: Intrinsics, cfg) -> Tuple[Rigid, int]:
    m, r = cfg["margin"], cfg["radius"]
    dev = rows.device
    img = F.pad(torch.cat([fpt, fnm, fok.to(real())[None]]), (m + r,) * 4)
    eye6 = torch.eye(6, dtype=real(), device=dev)
    cw = inverse(guess)
    it = 0
    while it < cfg["icp_iterations"]:
        _, code, mvalid = _project(rows, cw, k, m, r)
        read, inwin = _read(img, code, r)
        hit = inwin & (read[:, 6] > 0.5)
        read = torch.where(hit[:, None], read, 0.0)
        fp, fn = read[:, 0:3], read[:, 3:6]
        xc = ein("ij,ljyx->liyx", cw.linear, rows[:, PT]) + cw.translation[None, :, None, None]
        nc = ein("ij,ljyx->liyx", cw.linear, rows[:, NRM])
        diff = fp - xc
        ok = mvalid & hit & (code >= 0) & (torch.sum(diff * diff, 1) <= cfg["icp_max_corr_dist_sq"])
        if cfg["icp_normal_dot_min"] > 0.0:
            ok &= torch.sum(nc * fn, dim=1) > cfg["icp_normal_dot_min"]
        wgt = ok.to(real())
        res = torch.sum(fn * (xc - fp), dim=1)
        fn_last = fn.movedim(1, -1)
        jrow = torch.cat([torch.linalg.cross(xc.movedim(1, -1), fn_last, dim=-1), fn_last], -1)
        jw = jrow * wgt[..., None]
        jtj = ein("lyxi,lyxj->ij", jw, jrow) + 1e-8 * eye6
        jtr = ein("lyxi,lyx->i", jw, res)
        step = -torch.linalg.solve_ex(jtj, jtr, check_errors=False)[0]
        cw = reproject(compose(gn_update(step), cw))
        it += 1
        if float(torch.linalg.vector_norm(step)) < cfg["icp_convergence_tol"]:
            break
    return inverse(cw), it


def _elect(key, code, r, layers):
    """Nearest and second-nearest surfel landing on each pixel: ``(best
    key, best row code, second row code)``; row code = window code ·
    layers + layer, -1 where none. Ties keep the earlier candidate in
    (layer, dv, du) order."""
    w2 = 2 * r + 1
    _, hp, wp = key.shape
    h, w = hp - 2 * r, wp - 2 * r
    inf = torch.tensor(float("inf"), dtype=real(), device=key.device)
    bk = inf.expand(h, w).clone()
    sk = bk.clone()
    bc = torch.full((h, w), -1, dtype=torch.int32, device=key.device)
    sc = bc.clone()
    for lay in range(layers):
        for dv in range(-r, r + 1):
            for du in range(-r, r + 1):
                oc = (dv + r) * w2 + (du + r)
                ys, xs = r - dv, r - du
                cand = torch.where(code[lay, ys:ys + h, xs:xs + w] == oc,
                                   key[lay, ys:ys + h, xs:xs + w], inf)
                lt_b, lt_s = cand < bk, cand < sk
                sk = torch.where(lt_b, bk, torch.where(lt_s, cand, sk))
                sc = torch.where(lt_b, bc, torch.where(lt_s, oc * layers + lay, sc))
                bk = torch.where(lt_b, cand, bk)
                bc = torch.where(lt_b, oc * layers + lay, bc)
    return bk, bc, sc


def _select(rows_p, rc, r):
    """The row each pixel's row code points at (``rows_p (L, C, H+2R,
    W+2R)``), zero where the code is -1."""
    w2 = 2 * r + 1
    layers, c, hp, wp = rows_p.shape
    h, w = hp - 2 * r, wp - 2 * r
    ok = (rc >= 0) & (rc < layers * w2 * w2)
    cd = torch.where(ok, rc, (r * w2 + r) * layers)
    lay, oc = cd % layers, cd // layers
    ys = torch.arange(h, device=rc.device)[:, None] + r - (oc // w2 - r)
    xs = torch.arange(w, device=rc.device)[None, :] + r - (oc % w2 - r)
    flat = rows_p.permute(1, 0, 2, 3).reshape(c, layers * hp * wp)
    out = flat[:, (lay * (hp * wp) + ys * wp + xs).reshape(-1)].reshape(c, h, w)
    return torch.where(ok[None], out, 0.0)


def integrate(rows, fpt, fnm, fok, pose: Rigid, k: Intrinsics, cfg):
    m, r = cfg["margin"], cfg["radius"]
    layers, _, hm, wm = rows.shape
    h, w = hm - 2 * m, wm - 2 * m
    dev = rows.device
    zc, code, _ = _project(rows, inverse(pose), k, m, r)
    key = torch.where(code >= 0, zc, float("inf"))
    bk, bc, sc = _elect(F.pad(key, (r,) * 4, value=float("inf")),
                        F.pad(code, (r,) * 4, value=-1), r, layers)
    rows_p = F.pad(rows, (r,) * 4)
    win, sec = _select(rows_p, bc, r), _select(rows_p, sc, r)
    w_ok = (bc >= 0) & (win[VALID] > 0.5)
    s_ok = (sc >= 0) & (sec[VALID] > 0.5)

    pad = (m, m, m, m)
    fv = F.pad(fok, pad)
    zf = F.pad(fpt[2], pad)
    fpt_w = ein("ij,jyx->iyx", pose.linear, F.pad(fpt, pad)) + pose.translation[:, None, None]
    fnm_w = ein("ij,jyx->iyx", pose.linear, F.pad(fnm, pad))
    ys = torch.arange(hm, dtype=real(), device=dev)[:, None] - (k.cy + m)
    xs = torch.arange(wm, dtype=real(), device=dev)[None, :] - (k.cx + m)
    rad2 = torch.square(ys / f32(h, ys)) + torch.square(xs / f32(w, xs))
    wf = torch.exp(-2.0 * rad2) * fv

    conf = win[CONF]
    zw = torch.where(w_ok, bk, float("inf"))
    ndot = torch.sum(win[NRM] * fnm_w, dim=0)
    fuse = (fv & w_ok & (torch.abs(zw - zf) <= cfg["depth_fuse_thresh"])
            & (ndot > cfg["fuse_normal_dot_min"]))
    carve = fv & w_ok & ~fuse & (zw < zf - cfg["occlusion_thresh"])
    infront = fv & w_ok & ~fuse & (zf < zw - cfg["occlusion_thresh"])
    augment = fv & (~w_ok | infront)

    tot = conf + wf
    tsafe = torch.clamp(tot, min=1e-12)

    def avg(a, b):
        return (a * conf[None] + b * wf[None]) / tsafe[None]

    fused = win.clone()
    fused[PT] = avg(win[PT], fpt_w)
    navg = avg(win[NRM], fnm_w)
    fused[NRM] = navg / torch.clamp(torch.linalg.vector_norm(navg, dim=0, keepdim=True), min=1e-12)
    fused[CONF] = torch.clamp(tot, max=cfg["max_confidence"])
    carved = win.clone()
    carved[CONF] = conf - cfg["carve_penalty"]
    carved[VALID] = torch.where(carved[CONF] > 0.0, win[VALID], 0.0)
    new = torch.cat([fpt_w, fnm_w, wf[None], fv.to(real())[None]], dim=0)
    sec_live = torch.where(s_ok[None], sec, 0.0)
    win_live = torch.where(w_ok[None], win, 0.0)
    l0 = torch.where(fuse[None], fused, win_live)
    l0 = torch.where(carve[None], carved, l0)
    l0 = torch.where(augment[None], new, l0)
    l1 = torch.where(infront[None], win_live, sec_live)
    return torch.stack([l0, l1])


def run(depths: np.ndarray, k: Intrinsics, settings: dict, device
        ) -> Tuple[np.ndarray, torch.Tensor, List[int]]:
    """Splat fusion of one clip ``depths (F, H, W)``: ``(poses (F, 4, 4)
    camera-to-world, surfel rows (2, 8, H + 2m, W + 2m), GN iterations a
    frame)``."""
    cfg = dict(DEFAULTS, **settings)
    dev = torch.device(device)
    frames = torch.as_tensor(np.ascontiguousarray(depths, np.float32), device=dev).to(real())
    nf, h, w = frames.shape
    m = cfg["margin"]
    fpt, fnm, fok = _frame(frames[0], k)
    rows = torch.zeros((2, CHANNELS, h + 2 * m, w + 2 * m), dtype=real(), device=dev)
    v = fok.to(real())[None]
    rows[0, :, m:m + h, m:m + w] = torch.cat([fpt, fnm, v, v])
    pose = identity(device=dev)
    mats, iters = [pose.matrix()], [0]
    for f in range(1, nf):
        fpt, fnm, fok = _frame(frames[f], k)
        pose, it = localize(rows, fpt, fnm, fok, pose, k, cfg)
        rows = integrate(rows, fpt, fnm, fok, pose, k, cfg)
        mats.append(pose.matrix())
        iters.append(it)
    return torch.stack(mats).cpu().numpy(), rows, iters


def map_cloud(rows: torch.Tensor):
    """World points, validity, normals and confidence of both layers' surfels."""
    def flat(x):
        return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])

    return (flat(rows[:, PT]), (rows[:, VALID] > 0.5).reshape(-1), flat(rows[:, NRM]),
            rows[:, CONF].reshape(-1))
