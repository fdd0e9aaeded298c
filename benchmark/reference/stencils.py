"""Branchless local eikonal update in plain PyTorch: the reference's
operator.

Frozen copy of ``alifmm_tpu_torch/ops/stencils.py`` (lines 1-402: the ALI
wavefront-interpolation update, 8 square + 8 triangular stencils,
min-difference selection, phase velocity at the wavefront normal, with the
multi-stencil FD fallback: axis, diagonal and two knight's-move families),
which the sweep kernel K1 follows operation for operation.  Departures:
``local_update`` takes the phase velocity as a function of the reference's
own model (``reference/model.py``) instead of the port's ``Model``; the
square root is ``torch.sqrt`` (the reference runs in float64, where the
CPU's one-ulp difference from the IEEE root is far below what it judges);
the whole-grid helpers below ``local_update`` are left out.

Unknown points carry the sentinel ``INF`` (1e9, not IEEE infinity);
neighbours outside the grid are INF as well.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

sqrt = torch.sqrt

INF = 1.0e9
_BIG_DIFF = 1.0e30
SQRT2 = math.sqrt(2.0)
SQRT5 = math.sqrt(5.0)
_RAD2DEG = 180.0 / math.pi

# All 24 neighbour offsets (dz, dx) used by the two solvers.
OFFSETS: Tuple[Tuple[int, int], ...] = tuple(
    (dz, dx)
    for dz in (-2, -1, 0, 1, 2)
    for dx in (-2, -1, 0, 1, 2)
    if not (dz == 0 and dx == 0)
)

# Square ALI stencils: (A = far point, P, Q); diff = |t(P) - t(Q)|.
_SQ = (
    ((-2, 0), (-1, -1), (-1, 1)),
    ((0, 2), (-1, 1), (1, 1)),
    ((2, 0), (1, -1), (1, 1)),
    ((0, -2), (-1, -1), (1, -1)),
    ((-1, -1), (0, -1), (-1, 0)),
    ((-1, 1), (-1, 0), (0, 1)),
    ((1, 1), (1, 0), (0, 1)),
    ((1, -1), (0, -1), (1, 0)),
)

# Triangular ALI stencils: far, mid and diagonal points, the edge where the
# mid branch degenerates to (edge angle, dist 1), and the wavefront-time
# rule ('B' = the selected closer point; 'D' = always t(D), the stencil-0
# quirk of the reference).
_TRI = (
    dict(F=(2, 0), M=(1, 0), D=(1, 1), edge="left", eang=90.0, wt="D"),
    dict(F=(-2, 0), M=(-1, 0), D=(-1, 1), edge="left", eang=90.0, wt="B"),
    dict(F=(-2, 0), M=(-1, 0), D=(-1, -1), edge="right", eang=90.0, wt="B"),
    dict(F=(2, 0), M=(1, 0), D=(1, -1), edge="right", eang=90.0, wt="B"),
    dict(F=(0, -2), M=(0, -1), D=(1, -1), edge="top", eang=0.0, wt="B"),
    dict(F=(0, 2), M=(0, 1), D=(1, 1), edge="top", eang=0.0, wt="B"),
    dict(F=(0, 2), M=(0, 1), D=(-1, 1), edge="bottom", eang=0.0, wt="B"),
    dict(F=(0, -2), M=(0, -1), D=(-1, -1), edge="bottom", eang=0.0, wt="B"),
)

# Knight's-move stencil point cycles, as (dz, dx).
_KNIGHT_A = ((-2, -1), (-1, 2), (2, 1), (1, -2))
_KNIGHT_B = ((-2, 1), (1, 2), (2, -1), (-1, -2))


def _sel(cond, a, b, like):
    """``where`` whose scalar branches take the dtype of ``like`` (filled on
    its device: no copy from the host, which a CUDA graph could not
    capture)."""
    if not torch.is_tensor(a):
        a = like.new_full((), a)
    if not torch.is_tensor(b):
        b = like.new_full((), b)
    return torch.where(cond, a, b)


def _wavefront_vec_dist(xA, zA, xB, zB, xC, zC, yA, yB, yC):
    """Wavefront geometry with the target point at the origin and the
    arctan deferred: returns (dx, dz, zero_angle, dist); dist = -1 marks
    the degenerate case."""
    denom = yC - yA
    degen = denom == 0.0
    denom_safe = torch.where(degen, 1.0, denom)
    a = (yB - yA) / denom_safe
    xpos = (1.0 - a) * xA + a * xC
    zpos = (1.0 - a) * zA + a * zC
    dx = xB - xpos
    dz = zB - zpos
    zero_ang = degen | (dx == 0.0)
    norm = sqrt(dx * dx + dz * dz)
    norm_safe = torch.where(norm == 0.0, 1.0, norm)
    dist = torch.abs(dz * xB - dx * zB) / norm_safe
    dist = torch.where(degen | (norm == 0.0), -1.0, dist)
    return dx, dz, zero_ang, dist


def _ali_candidate(nbr, known, edges):
    """Best ALI stencil at every point: (angle, dist, wtime, inputs_max),
    dist = -1 where no stencil is usable.  Selection is a running strict
    less-than minimum, so the first stencil wins ties."""
    like = nbr[(0, 1)]
    sq = None
    for (A, P, Q) in _SQ:
        tA, tP, tQ = nbr[A], nbr[P], nbr[Q]
        valid = known[A] & known[P] & known[Q]
        diff = torch.where(valid, torch.abs(tP - tQ), _BIG_DIFF)
        swap = tP < tQ  # B = the smaller of P, Q; ties -> Q
        xB = _sel(swap, float(P[1]), float(Q[1]), like)
        zB = _sel(swap, float(P[0]), float(Q[0]), like)
        xC = _sel(swap, float(Q[1]), float(P[1]), like)
        zC = _sel(swap, float(Q[0]), float(P[0]), like)
        yB = torch.where(swap, tP, tQ)
        yC = torch.where(swap, tQ, tP)
        vdx, vdz, zro, dst = _wavefront_vec_dist(
            float(A[1]), float(A[0]), xB, zB, xC, zC, tA, yB, yC
        )
        mx = torch.maximum(tA, torch.maximum(tP, tQ))
        cand = (diff, vdx, vdz, zro, dst, yB, mx)
        if sq is None:
            sq = cand
        else:
            better = diff < sq[0]
            sq = tuple(torch.where(better, n, o) for n, o in zip(cand, sq))
    sq_min_diff, sq_dx, sq_dz, sq_zero, sq_dist, sq_wtime, sq_max = sq
    sq_any = sq_min_diff < _BIG_DIFF

    c1 = SQRT2 - 1.0
    c2 = 2.0 - SQRT2
    tri = None
    for spec in _TRI:
        F, M, D = spec["F"], spec["M"], spec["D"]
        tF, tM, tD = nbr[F], nbr[M], nbr[D]
        valid = (known[F] & known[M] & known[D]
                 & (tF < torch.minimum(tM, tD)))
        diff = torch.where(valid, torch.abs(c1 * tF + c2 * tM - tD),
                           _BIG_DIFF)
        m_branch = tM < tD
        xB = _sel(m_branch, float(M[1]), float(D[1]), like)
        zB = _sel(m_branch, float(M[0]), float(D[0]), like)
        xC = _sel(m_branch, float(D[1]), float(M[1]), like)
        zC = _sel(m_branch, float(D[0]), float(M[0]), like)
        yB = torch.where(m_branch, tM, tD)
        yC = torch.where(m_branch, tD, tM)
        vdx, vdz, zro, dst = _wavefront_vec_dist(
            float(F[1]), float(F[0]), xB, zB, xC, zC, tF, yB, yC
        )
        # boundary degenerate case, mid branch only: fixed angle, dist 1
        on_edge = m_branch & edges[spec["edge"]]
        oang = _sel(on_edge, spec["eang"], 0.0, like)
        dst = torch.where(on_edge, 1.0, dst)
        wt = tD if spec["wt"] == "D" else yB
        mx = torch.maximum(tM, tD)
        cand = (diff, vdx, vdz, zro, on_edge, oang, dst, wt, mx)
        if tri is None:
            tri = cand
        else:
            better = diff < tri[0]
            tri = tuple(torch.where(better, n, o) for n, o in zip(cand, tri))
    (tri_min_diff, tri_dx, tri_dz, tri_zero, tri_ovr, tri_oang, tri_dist,
     tri_wtime, tri_max) = tri
    tri_any = tri_min_diff < _BIG_DIFF

    on_boundary = edges["left"] | edges["right"] | edges["top"] | edges["bottom"]
    try_tri = (~sq_any) | on_boundary
    carry_diff = torch.where(sq_any, sq_min_diff, 1.0e6)
    use_tri = try_tri & tri_any & (tri_min_diff < carry_diff)

    sel_dx = torch.where(use_tri, tri_dx, sq_dx)
    sel_dz = torch.where(use_tri, tri_dz, sq_dz)
    sel_zero = torch.where(use_tri, tri_zero, sq_zero)
    sel_ovr = use_tri & tri_ovr
    sel_oang = torch.where(use_tri, tri_oang, 0.0)
    # the one arctan of the update, on the selected stencil
    dx_safe = torch.where(sel_zero, 1.0, sel_dx)
    angle = torch.remainder(torch.atan(sel_dz / dx_safe) * _RAD2DEG + 90.0,
                            180.0)
    angle = torch.where(sel_zero, 0.0, angle)
    angle = torch.where(sel_ovr, sel_oang, angle)
    dist = torch.where(use_tri, tri_dist, torch.where(sq_any, sq_dist, -1.0))
    wtime = torch.where(use_tri, tri_wtime, sq_wtime)
    inputs_max = torch.where(use_tri, tri_max, sq_max)
    return angle, dist, wtime, inputs_max


def _quad_solve(a, b, c, tref, tdiv, clamp_disc):
    rd1 = b * b - 4.0 * a * c
    ok = rd1 > 0.0
    if clamp_disc:
        ok = torch.ones_like(ok)
    rd1 = torch.clamp_min(rd1, 0.0)
    t = (tref + (-b + sqrt(rd1)) / (2.0 * a)) / tdiv
    return t, ok


def _axis_or_diag_family(nbr, known, slown, h, quadrants, family,
                         causal=False):
    """FD axis family (h = dnx) or diagonal family (h = sqrt(2) dnx) over
    ``quadrants`` [((J, K), quad_inb)]; returns the family minimum (INF if
    none).  Axis clamps a negative discriminant, diagonal skips it; the
    two-first-order constant and the tdiv quirks differ per family."""
    clamp_disc = family == "axis"
    best = None
    for (J, K), quad_inb in quadrants:
        J2 = (2 * J[0], 2 * J[1])
        K2 = (2 * K[0], 2 * K[1])
        tJ, tJ2, tK, tK2 = nbr[J], nbr[J2], nbr[K], nbr[K2]
        kJ, kJ2, kK, kK2 = known[J], known[J2], known[K], known[K2]
        swj = kJ2 & kJ & (tJ >= tJ2)
        swk = kK2 & kK & (tK >= tK2)
        e1 = 4.0 * tJ - tJ2
        e2 = 4.0 * tK - tK2
        hs = h * slown
        h2s = 2.0 * hs

        # priority-ordered branch table (exactly one fires per point)
        b_1 = swj & swk
        b_2 = swj & ~swk & kK
        b_3 = swj & ~swk & ~kK
        b_4 = ~swj & kJ & swk
        b_5 = ~swj & kJ & ~swk & kK
        b_6 = ~swj & kJ & ~swk & ~kK
        b_7 = ~swj & ~kJ & swk
        b_8 = ~swj & ~kJ & ~swk & kK
        any_b = b_1 | b_2 | b_3 | b_4 | b_5 | b_6 | b_7 | b_8

        like = tJ
        a = _sel(b_1 | b_2 | b_4, 18.0, _sel(b_5, 2.0, 1.0, like), like)
        b = torch.where(
            b_1, -6.0 * (e1 + e2),
            torch.where(
                b_2, -6.0 * (3.0 * tK + e1),
                torch.where(
                    b_4, -6.0 * (3.0 * tJ + e2),
                    torch.where(b_5, -2.0 * (tK + tJ), 0.0),
                ),
            ),
        )
        t3K = 3.0 * tK
        t3J = 3.0 * tJ
        tJh = tJ + hs
        tKh = tK + hs
        c_b5 = (hs * hs if clamp_disc else (4.0 / 9.0) * hs * hs)
        c = torch.where(
            b_1, e1 * e1 + e2 * e2 - 4.0 * (h2s * h2s),
            torch.where(
                b_2, t3K * t3K + e1 * e1 - 4.0 * (h2s * h2s),
                torch.where(
                    b_3, -(h2s * h2s),
                    torch.where(
                        b_4, t3J * t3J + e2 * e2 - 12.0 * hs * hs,
                        torch.where(
                            b_5, tK * tK + tJ * tJ - c_b5,
                            torch.where(
                                b_6, -(tJh * tJh),
                                torch.where(b_7, -(h2s * h2s), -(tKh * tKh)),
                            ),
                        ),
                    ),
                ),
            ),
        )
        tref = torch.where(b_3, e1, torch.where(b_7, e2, 0.0))
        if clamp_disc:  # axis: only the vertical 2nd-order-only branch
            tdiv = _sel(b_7, 3.0, 1.0, like)
        else:
            tdiv = _sel(b_3 | b_7, 3.0, 1.0, like)
        t, ok = _quad_solve(a, b, c, tref, tdiv, clamp_disc)
        if causal:
            # a candidate below the values it was built from reflects a
            # not-yet-converged neighbourhood
            uses_j = b_1 | b_2 | b_3 | b_4 | b_5 | b_6
            uses_k = b_1 | b_2 | b_4 | b_5 | b_7 | b_8
            imax = torch.maximum(torch.where(uses_j, tJ, -INF),
                                 torch.where(uses_k, tK, -INF))
            ok = ok & (t >= imax)
        cand = torch.where(any_b & ok & quad_inb, t, INF)
        best = cand if best is None else torch.minimum(best, cand)
    return best


def _knight_family(nbr, known, inb, slown, dnx, cycle, causal=False):
    """FD knight's-move family; a pair counts only when both of its points
    lie inside the grid."""
    u = SQRT5 * dnx
    best = None
    for l in range(4):
        p = cycle[l]
        q = cycle[(l + 1) % 4]
        tp, tq = nbr[p], nbr[q]
        pair_inb = inb[p] & inb[q]
        kp, kq = known[p] & pair_inb, known[q] & pair_inb
        us = u * slown
        both = kp & kq
        a = _sel(both, 2.0, 1.0, tp)
        b = torch.where(both, -2.0 * (tq + tp), 0.0)
        c = torch.where(both, tq * tq + tp * tp - 2.0 * us * us, -(us * us))
        tref = torch.where(both, 0.0, torch.where(kp, tp, tq))
        rd1 = torch.clamp_min(b * b - 4.0 * a * c, 0.0)
        t = tref + (-b + sqrt(rd1)) / (2.0 * a)
        ok = kp | kq
        if causal:
            imax = torch.maximum(torch.where(kp, tp, -INF),
                                 torch.where(kq, tq, -INF))
            ok = ok & (t >= imax)
        cand = torch.where(ok, t, INF)
        best = cand if best is None else torch.minimum(best, cand)
    return best


def _fouds_candidate(nbr, known, inb, fbs, tt_center, dnx, causal=False):
    """Multi-stencil FD estimate: min over the four families, then min with
    the existing value.  A quadrant participates only when both of its
    primary points are inside the grid."""
    axis_quads = [
        (((0, jx), (kz, 0)), inb[(0, jx)] & inb[(kz, 0)])
        for jx in (-1, 1)
        for kz in (-1, 1)
    ]
    travm = _axis_or_diag_family(nbr, known, fbs[0], dnx, axis_quads,
                                 family="axis", causal=causal)
    diag_quads = [
        ((d, s), inb[d] & inb[s])
        for d in ((1, -1), (-1, 1))
        for s in ((-1, -1), (1, 1))
    ]
    travmd = _axis_or_diag_family(nbr, known, fbs[1], SQRT2 * dnx,
                                  diag_quads, family="diag", causal=causal)
    out = torch.minimum(travm, travmd)
    out = torch.minimum(
        out, _knight_family(nbr, known, inb, fbs[2], dnx, _KNIGHT_A, causal))
    out = torch.minimum(
        out, _knight_family(nbr, known, inb, fbs[3], dnx, _KNIGHT_B, causal))
    return torch.minimum(out, tt_center)


def local_update(
    nbr: Dict[Tuple[int, int], torch.Tensor],
    known: Dict[Tuple[int, int], torch.Tensor],
    inb: Dict[Tuple[int, int], torch.Tensor],
    tt_center: torch.Tensor,
    veln,
    velpn,
    vel_map,
    stif,
    fbs,
    edges,
    phase_velocity,
    dnx,
    causal: bool = False,
    use_ali: bool = True,
    use_fd: bool = True,
):
    """One local solve at every point of a block: the ALI update where a
    stencil is usable, else the multi-stencil FD estimate (INF where
    neither applies).  ``causal=True`` also rejects candidates below the
    largest stencil value they were computed from (the sweeps'
    mode); ``causal=False`` is the reference operator.  ``fbs`` is indexed
    positionally (four fallback-slowness views); ``phase_velocity(eff,
    velpn, vel_map, stif)`` is the phase velocity at the effective angle.

    ``use_ali=False`` returns the FD estimate alone (monotone upwind: the
    parallel-in-block sweeps and an FD phase-1 envelope rely on it);
    ``use_fd=False`` takes INF for the fallback, so that a replace
    accumulation keeps the value it had where no ALI stencil applies (the
    FD-free polish).  One of the two must hold."""
    if not (use_ali or use_fd):
        raise ValueError("local_update needs at least one of use_ali/use_fd")
    if use_fd:
        fouds_val = _fouds_candidate(nbr, known, inb, fbs, tt_center, dnx,
                                     causal)
    else:
        fouds_val = torch.full_like(tt_center, INF)
    if not use_ali:
        return fouds_val
    angle, dist, wtime, imax = _ali_candidate(nbr, known, edges)
    eff = torch.remainder(veln - angle, 180.0)
    vel = phase_velocity(eff, velpn, vel_map, stif)
    ali_val = wtime + dist * dnx / vel
    ali_ok = dist >= 0.0
    if causal:
        ali_ok = ali_ok & (ali_val >= imax)
    return torch.where(ali_ok, ali_val, fouds_val)
