"""The rigid 3-D Gauss-Newton step of the combined and symmetric metrics as
three launches (``csrc/gn_kernels.cu``), and its plain version.

:func:`gauss_newton_3d` is what :func:`.transform_estimation.estimate_rigid_combined_metric`
and :func:`.transform_estimation.estimate_rigid_symmetric_metric` run for
one problem of float32 CUDA tensors: the weighted means, then for each GN
iteration JᵀJ / Jᵀr summed over the rows, the 6×6 solve, the two-sided
update and the uncentred result, written into one output. A further
iteration is taken, as on the einsum path, only while the last step's norm
is at or above the tolerance (one host read an iteration after the first).

Accumulator width and order (the kernels' and :func:`gn_step_plain`'s):
every row is read as float32 and computed in float64 (the weight ``w_pp +
w_pl`` is summed in float32 first, as the einsum path does), and every sum
accumulates in float64. A pass runs ``B = min(⌈N / 256⌉, 256)`` blocks of
256 threads; thread ``g`` adds rows ``g, g + 256·B, …`` in order; a block
halves within each warp (lane ``l`` adds ``l + 16``, then ``+ 8``, …),
then over its 8 warps' sums (``w + 4``, ``+ 2``, ``+ 1``); the B partials
are padded to 256 with zeros and halved in the same order by one block.
The system ``(JᵀJ + 1e-12·I) x = −g`` is solved by LU with
partial pivoting (the first row of the largest ``|pivot|``). The plain
version repeats each operation in that order, so the two agree bit for bit
on the card; it is the wrapper's route for CPU tensors. :func:`gn_step_kernel`
is one launcher call, the kernels' side of that comparison.

Launch counts: ``native.launch_counts["gn_step"]`` counts the launcher's
calls (the means pass with the first, the sums pass and the solve with
each).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import native
from ..core.transforms import Transform
from ..utils.profiling import count

THREADS = 256  # csrc/gn_kernels.cu kThreads: a block, 8 warps
WARP = 32
MAX_BLOCKS = 256  # kMaxBlocks: the solve's block holds one partial a thread
MEANS, SUMS, STATE = 8, 27, 12  # kMeans, kSums, kState
SUMS_AT = MAX_BLOCKS * MEANS
STATE_AT = SUMS_AT + MAX_BLOCKS * SUMS
WORKSPACE = STATE_AT + STATE  # float64: the partials of both passes, the step's transform
OUT = 13  # float32: R (9), t (3), the last step's norm
_EPS = 1e-12  # the least weight sum the means divide by; JᵀJ's damping


def blocks_for(n: int) -> int:
    """The grid of both passes for ``n`` rows."""
    return min(max(-(-n // THREADS), 1), MAX_BLOCKS)


# Upper-triangle index of JᵀJ's entry (i, j), i <= j, row by row.
TRI = {(i, j): k for k, (i, j) in enumerate((i, j) for i in range(6) for j in range(i, 6))}


def _row_stride(name, t: torch.Tensor, width: Optional[int], n: int) -> int:
    """``t``'s row stride in elements, after checking its type and shape."""
    native.check("gn_step", t, name, (torch.float32,), (n,) if width is None else (n, width))
    if width is not None and t.stride(-1) != 1:
        raise ValueError(f"gn_step: {name} needs unit stride along its last axis (see step_rows)")
    st = t.stride(0) if n > 1 else width or 1
    if (n - 1) * st + (width or 1) >= 2**31:
        raise ValueError(f"gn_step: {name} spans 2^31 elements or more")
    return st


def takes(src: torch.Tensor, *others: Optional[torch.Tensor]) -> bool:
    """The kernels take one 3-D problem: ``src`` ``(N, 3)``, it and every
    other tensor given (``None``, an absent weight or normal, passes)
    float32 on a CUDA device."""
    return (src.dim() == 2 and src.shape[-1] == 3
            and all(t is None or (t.is_cuda and t.dtype == torch.float32) for t in (src,) + others))


def step_rows(src, dst, src_normals, dst_normals, point_weights, plane_weights):
    """The six row arrays a step reads: points and normals with unit stride
    along their last axis (copied where they have none), the weights
    ``(N,)`` (broadcast; None: point 0, plane 1)."""
    n = src.shape[0]
    src, dst, src_normals, dst_normals = (
        t if t is None or t.stride(-1) == 1 else t.contiguous() for t in (src, dst, src_normals, dst_normals))
    w_pp = torch.zeros_like(src[:, 0]) if point_weights is None else torch.broadcast_to(point_weights, (n,))
    w_pl = torch.ones_like(src[:, 0]) if plane_weights is None else torch.broadcast_to(plane_weights, (n,))
    return src, dst, src_normals, dst_normals, w_pp, w_pl


def gauss_newton_3d(
    src: torch.Tensor,
    dst: torch.Tensor,
    src_normals: Optional[torch.Tensor],
    dst_normals: torch.Tensor,
    point_weights: Optional[torch.Tensor],
    plane_weights: Optional[torch.Tensor],
    max_iterations: int,
    convergence_tol: float,
) -> Tuple[Transform, torch.Tensor]:
    """The combined (``src_normals`` None) or symmetric metric's GN estimate
    for one problem ``(N, 3)``, at least one iteration: ``(Transform,
    valid)``, ``valid`` when at least 3 rows carry weight. CUDA tensors
    take the kernels (each GN iteration counted as
    ``gn_step_route_fused``), CPU tensors the plain version. Weights None:
    point 0, plane 1."""
    if max_iterations < 1:
        raise ValueError(f"gn_step: max_iterations {max_iterations}, wants at least 1")
    rows = step_rows(src, dst, src_normals, dst_normals, point_weights, plane_weights)
    plain = native.on_cpu("gn_step", *(t for t in rows if t is not None))
    ws = None
    for it in range(max_iterations):
        if plain:
            ws, out, valid = gn_step_plain(*rows, ws)
        else:
            count("gn_step_route_fused", 1)
            ws, out, valid = gn_step_kernel(*rows, ws)
        if it + 1 < max_iterations and not (out[12].item() >= convergence_tol):
            break
    return Transform(out[:9].view(3, 3), out[9:12]), valid


def gn_step_kernel(src, dst, src_normals, dst_normals, w_pp, w_pl, ws: Optional[torch.Tensor] = None):
    """One launcher call on the card, :func:`gn_step_plain`'s counterpart:
    the means pass when ``ws`` is None (the first GN iteration), then the
    sums pass and the solve. ``ws`` is written in place. Returns ``(ws,
    out, valid)``; :func:`written` picks the parts of ``ws`` the call wrote."""
    n = src.shape[0]
    first = ws is None
    if first:
        ws = torch.empty(WORKSPACE, dtype=torch.float64, device=src.device)
    out = torch.empty(OUT, dtype=torch.float32, device=src.device)
    valid = torch.empty((), dtype=torch.bool, device=src.device)
    native.launch("gn_step_launch", *_launch_args(src, dst, src_normals, dst_normals, w_pp, w_pl, n),
                  int(first), ws.data_ptr(), out.data_ptr(), valid.data_ptr())
    return ws, out, valid


def written(ws: torch.Tensor, n: int) -> torch.Tensor:
    """The parts of the workspace the launches write for ``n`` rows: both
    passes' partials and the step's transform."""
    b = blocks_for(n)
    return torch.cat([ws[:b * MEANS], ws[SUMS_AT:SUMS_AT + b * SUMS], ws[STATE_AT:]])


def _launch_args(src, dst, src_normals, dst_normals, w_pp, w_pl, n):
    """The launcher's row pointers and strides (0 and 0 for the combined
    metric's absent source normals), then ``n`` and the grid."""
    args = []
    for name, t, width in (("src", src, 3), ("dst", dst, 3), ("src_normals", src_normals, 3),
                           ("dst_normals", dst_normals, 3), ("point_weights", w_pp, None),
                           ("plane_weights", w_pl, None)):
        args += [None, 0] if t is None else [t.data_ptr(), _row_stride(name, t, width, n)]
    return args + [n, blocks_for(n)]


# ---------------------------------------------------------------------------
# The plain version: the three launches' arithmetic in their order.
# ---------------------------------------------------------------------------


def _halve(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a power of two long): first half plus
    second half until one is left."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _block_sum(x: torch.Tensor) -> torch.Tensor:
    """``(..., 256)`` → ``(...)``: within each warp, then over the warps."""
    return _halve(_halve(x.reshape(x.shape[:-1] + (THREADS // WARP, WARP))))


def _pass_partials(c: torch.Tensor, blocks: int) -> torch.Tensor:
    """A pass's partials ``(blocks, K)`` of the rows' terms ``c (K, N)``:
    each thread's rows in order, then each block's threads."""
    k, n = c.shape
    span = blocks * THREADS
    rounds = max(-(-n // span), 1)
    c = torch.nn.functional.pad(c, (0, rounds * span - n)).reshape(k, rounds, span)
    acc = torch.zeros((k, span), dtype=c.dtype, device=c.device)
    for r in range(rounds):
        acc = acc + c[:, r]
    return _block_sum(acc.reshape(k, blocks, THREADS)).T


def _combine(partials: torch.Tensor) -> torch.Tensor:
    """``(blocks, K)`` → ``(K,)``: one block, thread i on partial i."""
    pad = torch.zeros((MAX_BLOCKS - partials.shape[0], partials.shape[1]), dtype=partials.dtype,
                      device=partials.device)
    return _block_sum(torch.cat([partials, pad]).T)


def _dot3(x, y):
    return (x[0] * y[0] + x[1] * y[1]) + x[2] * y[2]


def _cross(x, y):
    return [x[1] * y[2] - x[2] * y[1], x[2] * y[0] - x[0] * y[2], x[0] * y[1] - x[1] * y[0]]


def _means(m):
    """μs, μd from the combined means ``m (8,)``."""
    den = torch.clamp(m[0], min=_EPS)
    return [m[1 + c] / den for c in range(3)], [m[4 + c] / den for c in range(3)]


def means_pass_plain(src, dst, w_pp, w_pl) -> torch.Tensor:
    """``gn_means_kernel``: partials ``(B, 8)`` of Σw, Σw·s, Σw·d and the
    rows with ``w > 0``."""
    wf = w_pp + w_pl
    w = wf.double()
    s, d = src.double(), dst.double()
    c = torch.stack([w] + [w * s[:, i] for i in range(3)] + [w * d[:, i] for i in range(3)]
                    + [(wf > 0).double()])
    return _pass_partials(c, blocks_for(src.shape[0]))


def sums_pass_plain(src, dst, src_normals, dst_normals, w_pp, w_pl, means_partials,
                    state) -> torch.Tensor:
    """``gn_sums_kernel``: partials ``(B, 27)`` of JᵀJ's upper triangle and
    ``g = Σ w J r``, over the rows centred on the means and moved by
    ``state`` (R row by row, t)."""
    wpp, wpl = w_pp.double(), w_pl.double()
    mu_s, mu_d = _means(_combine(means_partials))
    rot = [[state[3 * i + j] for j in range(3)] for i in range(3)]
    tr = [state[9 + i] for i in range(3)]
    s, d, nd = (a.double() for a in (src, dst, dst_normals))
    cs = [s[:, c] - mu_s[c] for c in range(3)]
    sp = [_dot3(rot[c], cs) + tr[c] for c in range(3)]
    n = [nd[:, c] for c in range(3)]
    if src_normals is not None:
        ns = src_normals.double()
        n = [n[c] + _dot3(rot[c], [ns[:, 0], ns[:, 1], ns[:, 2]]) for c in range(3)]
    cd = [d[:, c] - mu_d[c] for c in range(3)]
    p = [sp[c] + cd[c] for c in range(3)]
    e = [sp[c] - cd[c] for c in range(3)]
    jac = _cross(p, n) + n
    res = _dot3(n, e)
    c = [None] * SUMS
    for a in range(6):
        wa = wpl * jac[a]
        for b in range(a, 6):
            c[TRI[a, b]] = wa * jac[b]
        c[21 + a] = wa * res
    pp = wpp != 0
    q = [p[i] * p[i] for i in range(3)]
    terms = {
        (0, 0): wpp * (q[1] + q[2]), (1, 1): wpp * (q[0] + q[2]), (2, 2): wpp * (q[0] + q[1]),
        (0, 1): -(wpp * (p[0] * p[1])), (0, 2): -(wpp * (p[0] * p[2])), (1, 2): -(wpp * (p[1] * p[2])),
        (0, 4): -(wpp * p[2]), (0, 5): wpp * p[1], (1, 3): wpp * p[2],
        (1, 5): -(wpp * p[0]), (2, 3): -(wpp * p[1]), (2, 4): wpp * p[0],
        (3, 3): wpp, (4, 4): wpp, (5, 5): wpp,
    }
    for ij, term in terms.items():
        k = TRI[ij]
        c[k] = torch.where(pp, c[k] + term, c[k])
    h = _cross(p, e) + e
    for a in range(6):
        c[21 + a] = torch.where(pp, c[21 + a] + wpp * h[a], c[21 + a])
    return _pass_partials(torch.stack(c), blocks_for(src.shape[0]))


def solve_plain(means_partials, sums_partials, state):
    """``gn_solve_kernel``: ``(state', out (13,) float32, valid)``."""
    m = _combine(means_partials)
    mu_s, mu_d = _means(m)
    v = _combine(sums_partials)
    a = [[None] * 6 for _ in range(6)]
    b = [None] * 6
    for i in range(6):
        for j in range(i, 6):
            a[i][j] = a[j][i] = v[TRI[i, j]]
        a[i][i] = a[i][i] + _EPS
        b[i] = -v[21 + i]
    for c in range(6):
        piv = torch.tensor(c, device=v.device)
        best = torch.abs(a[c][c])
        for i in range(c + 1, 6):
            more = torch.abs(a[i][c]) > best
            best = torch.where(more, torch.abs(a[i][c]), best)
            piv = torch.where(more, i, piv)
        for i in range(c + 1, 6):
            sw = piv == i
            for j in range(6):
                a[c][j], a[i][j] = torch.where(sw, a[i][j], a[c][j]), torch.where(sw, a[c][j], a[i][j])
            b[c], b[i] = torch.where(sw, b[i], b[c]), torch.where(sw, b[c], b[i])
        for i in range(c + 1, 6):
            lc = a[i][c] / a[c][c]
            for j in range(c + 1, 6):
                a[i][j] = a[i][j] - lc * a[c][j]
            b[i] = b[i] - lc * b[c]
    x = [None] * 6
    for i in range(5, -1, -1):
        s = b[i]
        for j in range(i + 1, 6):
            s = s - a[i][j] * x[j]
        x[i] = s / a[i][i]

    na = torch.sqrt(_dot3(x, x))
    th = torch.atan(na)
    co, si = torch.cos(th), torch.sin(th)
    om = 1.0 - co
    u = [torch.where(na > 0, x[c] / na, 0.0) for c in range(3)]
    k = [[None, -u[2], u[1]], [u[2], None, -u[0]], [-u[1], u[0], None]]
    rh = [[om * u[i] * u[j] + (co if i == j else si * k[i][j]) for j in range(3)] for i in range(3)]
    ta = [co * x[3 + i] for i in range(3)]
    rd = [[_dot3(rh[i], [rh[0][j], rh[1][j], rh[2][j]]) for j in range(3)] for i in range(3)]
    td = [_dot3(rh[i], ta) for i in range(3)]
    rs = [[state[3 * i + j] for j in range(3)] for i in range(3)]
    ts = [state[9 + i] for i in range(3)]
    rn = [[_dot3(rd[i], [rs[0][j], rs[1][j], rs[2][j]]) for j in range(3)] for i in range(3)]
    tn = [_dot3(rd[i], ts) + td[i] for i in range(3)]
    t_out = [(tn[i] - _dot3(rn[i], mu_s)) + mu_d[i] for i in range(3)]
    nrm = torch.zeros((), dtype=torch.float64, device=v.device)
    for c in range(6):
        nrm = nrm + x[c] * x[c]
    new_state = torch.stack([rn[i][j] for i in range(3) for j in range(3)] + tn)
    out = torch.stack([rn[i][j] for i in range(3) for j in range(3)] + t_out + [torch.sqrt(nrm)])
    return new_state, out.float(), m[7] >= 3.0


def gn_step_plain(src, dst, src_normals, dst_normals, w_pp, w_pl, ws: Optional[torch.Tensor]):
    """Plain version of one launcher call: the means pass when ``ws`` is
    None (the first GN iteration; the step's transform starts at the
    identity), then the sums pass and the solve. Returns ``(ws, out,
    valid)``; ``ws`` holds the written parts of the kernels' workspace."""
    n = src.shape[0]
    blocks = blocks_for(n)
    if ws is None:
        ws = torch.zeros(WORKSPACE, dtype=torch.float64, device=src.device)
        ws[:blocks * MEANS] = means_pass_plain(src, dst, w_pp, w_pl).reshape(-1)
        ws[STATE_AT:] = torch.tensor([1.0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0], dtype=torch.float64)
    means = ws[:blocks * MEANS].reshape(blocks, MEANS)
    sums = sums_pass_plain(src, dst, src_normals, dst_normals, w_pp, w_pl, means, ws[STATE_AT:])
    ws = ws.clone()
    ws[SUMS_AT:SUMS_AT + blocks * SUMS] = sums.reshape(-1)
    state, out, valid = solve_plain(means, sums, ws[STATE_AT:])
    ws[STATE_AT:] = state
    return ws, out, valid
