"""Batched Fermat ray tracing through receiver travel-time fields.

Counterpart of ``alifmm_tpu/rays.py`` (the plane-search tracer): the march
of ``trace_rays(mode="interp")`` with Simpson or crossing-walk candidate
scoring, even/odd-wave Fermat relaxation (``relax_rays``) and exact
sorted-crossing time integration (``ray_times``/``segment_time``).

On CUDA tensors the march and the relaxation with the ray times run as
hand-written kernels (``ops/cuda_rays.py``, ``csrc/rays.cu``): one launch
marches every ray to its end with no host read per step, one more relaxes
every ray and adds up its time.  This module holds their plain PyTorch
twins -- ``march_plain`` (a Python loop over steps, vectorised over rays
and candidates, one host read per step), ``relax_and_times_plain`` (the
waves of ``relax_wave_plain``, then ``ray_times_plain``) and the segment
integrators -- which the wrappers take for CPU tensors and which the
kernels are held against on the card.  ``mod180`` states the kernels'
floor-mod by 180, which gives ``torch.remainder``'s bits.
``PLAIN_STEPS`` counts plain march steps.

The twins give the same bits on the CPU and on the card: divisors are
tensors (PyTorch's CUDA division by a Python number multiplies by its
reciprocal), ``argmax``/``argmin`` are written as first-wins selections
(a CUDA reduction does not promise the first of equal values), and sums
the kernels must follow are added in a stated order.

Coordinates follow the reference convention: ray (x, y) in fine-grid
units, fields indexed [y, x], materials looked up on the model grid.
"""

from __future__ import annotations

import math
import typing

import torch

from . import grid as gridlib
from . import materials as mats
from .ops import cuda_rays

__all__ = ["segment_time", "segment_time_quad", "segment_time_quad3",
           "ray_times", "relax_rays", "trace_rays", "MarchSpec",
           "march_spec", "march_plain", "relax_wave_plain", "ray_times_plain",
           "relax_and_times_plain", "mod180", "PLAIN_STEPS"]

_BIG = 1.0e30
_RAD2DEG = 180.0 / math.pi
PLAIN_STEPS = 0


class MarchSpec(typing.NamedTuple):
    """Static shape of a march: fine cells per model cell ``s``, model
    cells per step far from (``k_step``) and near (``near_step``) the
    receiver, search-plane half width ``plane_dist`` in model cells,
    candidate spacing ``stride`` and count ``K`` per plane, the step
    budget, the candidate scorer (``cuda_rays.SIMPSON3``, ``SIMPSON5`` or
    ``WALK``) and the walk's crossing budget."""

    s: int
    k_step: int
    near_step: int
    plane_dist: int
    stride: float
    K: int
    max_steps: int
    scorer: int
    in_cross: int


def _full(like, v):
    return torch.full_like(like, v)


def _scalar(model, v):
    """``v`` as a 0-d tensor beside the model: a tensor divisor divides
    the same way on the CPU and on the card."""
    return torch.full((), float(v), dtype=model.dtype, device=model.device)


def _argmax_first(rows):
    """Index of the largest of ``rows`` (tensors of one shape), the first
    of equal values."""
    best = rows[0]
    idx = torch.zeros(best.shape, dtype=torch.int64, device=best.device)
    for i, r in enumerate(rows[1:], start=1):
        better = r > best
        idx = torch.where(better, i, idx)
        best = torch.where(better, r, best)
    return idx


def _argmin_first(val):
    """Index of the smallest value along dim 1, the first of equal ones."""
    n = val.shape[1]
    low = val.min(dim=1, keepdim=True).values
    col = torch.arange(n, device=val.device)[None, :]
    return torch.where(val == low, col, n).min(dim=1).values.clamp_max(n - 1)


def _material_flat(model: gridlib.Model, exact: bool = False):
    """(Z*X, 4) per-cell rows (veln, vel_map, unified-curve index, 0) for
    the segment integrators (the JAX package's fast path, whose rows are
    the first three columns): built on the model's device, with no host
    read, and padded so that a kernel reads a row in one aligned load."""
    if exact or model.ray_curve_idx is None:
        raise NotImplementedError("exact per-crossing Christoffel materials")
    Z, X = model.shape
    cols = [model.veln, model.vel_map, model.ray_curve_idx.to(model.dtype),
            torch.zeros_like(model.veln)]
    return torch.stack(cols, dim=-1).reshape(Z * X, 4)


def mod180(x):
    """``torch.remainder(x, 180)`` bit for bit, signed zeros included, as
    the kernels compute it: for |x| < 360 the remainder of fmod is x or
    x -+ 180 with the sign of x, and |x| - 180 is exact there (Sterbenz),
    so one compare and one add replace fmod's loop."""
    ax = x.abs()
    r = torch.where(ax < 180.0, x, torch.copysign(ax - 180.0, x))
    r = torch.where(r < 0, r + 180.0, r)
    return torch.where(ax < 360.0, r, torch.remainder(x, 180.0))


def _group_velocity_cell(model, mat_row, eff):
    """Group velocity at effective angle ``eff`` for gathered cell rows,
    from the unified per-cell curve table."""
    return mats.interp_table_gather(model.ray_curves, eff,
                                    mat_row[..., 2].to(torch.int64),
                                    mat_row[..., 1])


def _angle(dx, dy):
    dx_zero = dx == 0
    return torch.where(
        dx_zero, 0.0,
        torch.atan(dy / torch.where(dx_zero, 1.0, dx)) * _RAD2DEG)


def segment_time(model: gridlib.Model, mat_flat, x1, y1, x2, y2,
                 subgrid_size, max_cross: int = 16):
    """Straight-segment travel time between fine-grid points, integrated
    cell by cell: the x- and y-boundary crossings (at most ``max_cross``
    per axis) are merged by one sort, each interval's midpoint picks its
    cell, and the last breakpoint is always the segment end.  The
    intervals are added in sorted order."""
    Z, X = model.shape
    dt = model.dtype
    s = _scalar(model, subgrid_size)
    x1, x2 = x1 / s, x2 / s
    y1, y2 = y1 / s, y2 / s
    dx = x2 - x1
    dy = y2 - y1
    dx_zero = dx == 0
    dy_zero = dy == 0
    angle = _angle(dx, dy)
    length = torch.sqrt(dx * dx + dy * dy)

    shp = torch.broadcast_shapes(x1.shape, x2.shape, y1.shape, y2.shape)
    x1 = x1.expand(shp)
    y1 = y1.expand(shp)
    k = torch.arange(max_cross, dtype=dt, device=x1.device).reshape(
        (max_cross,) + (1,) * len(shp))

    def axis_ts(p1, d, zero):
        # crossing parameters of the boundaries round(p1) + sign(d) (k + 1/2),
        # clipped to the segment so out-of-range crossings become
        # zero-length tail intervals
        sgn = torch.where(d < 0, -1.0, 1.0).to(dt)
        d_safe = torch.where(zero, 1.0, d)
        t = (torch.round(p1) + sgn * (k + 0.5) - p1) / d_safe
        return torch.where(zero, 1.0, torch.clamp(t, 0.0, 1.0))

    tx = axis_ts(x1, dx, dx_zero)
    ty = axis_ts(y1, dy, dy_zero)
    one = torch.ones((1,) + shp, dtype=dt, device=x1.device)
    t = torch.sort(torch.cat([tx.expand((max_cross,) + shp),
                              ty.expand((max_cross,) + shp), one], 0), 0).values
    t0 = torch.cat([torch.zeros_like(one), t[:-1]], 0)
    tm = 0.5 * (t0 + t)
    x_pos = torch.clamp(torch.round(x1 + tm * dx).to(torch.int64), 0, X - 1)
    y_pos = torch.clamp(torch.round(y1 + tm * dy).to(torch.int64), 0, Z - 1)
    dists = model.dnx * length * (t - t0)
    row = mat_flat[y_pos * X + x_pos]
    eff = torch.remainder(row[..., 0] - angle[None], 180.0)
    vel = _group_velocity_cell(model, row, eff)
    return _sum_in_order(dists / vel)


def _sum_in_order(terms):
    """Sum over dim 0, added from the first term to the last (the order
    the CUDA kernels follow; ``torch.sum`` states none)."""
    acc = terms[0]
    for k in range(1, terms.shape[0]):
        acc = acc + terms[k]
    return acc


def _segment_time_walk(model: gridlib.Model, mat_flat, x1, y1, x2, y2,
                       subgrid_size, max_cross: int = 16):
    """Sequential crossing-walk segment integrator: one cell-boundary
    crossing per step, ``max_cross`` crossings in all, cut off beyond.
    It agrees with ``segment_time`` to rounding, but the march's candidate
    minimum sits in a valley flat to 1e-9 s, so the ``quad_vel=False``
    scorer follows the walk's own arithmetic step for step."""
    Z, X = model.shape
    s = _scalar(model, subgrid_size)
    x1, x2 = x1 / s, x2 / s
    y1, y2 = y1 / s, y2 / s
    x1, y1, x2, y2 = torch.broadcast_tensors(x1, y1, x2, y2)

    dx_zero = x2 == x1
    slope = (y2 - y1) / torch.where(dx_zero, 1.0, x2 - x1)
    angle = torch.where(dx_zero, 0.0, torch.atan(slope) * _RAD2DEG)
    m = torch.where(dx_zero, 0.0, slope)
    c = y1 - m * x1
    dir_x = torch.where(x1 < x2, 1.0, -1.0).to(x1.dtype)
    dir_y = torch.where(y1 < y2, 1.0, -1.0).to(x1.dtype)
    m_zero = m == 0
    m_safe = torch.where(m_zero, 1.0, m)

    prev_x, prev_y = x1, y1
    next_x = torch.round(x1) + dir_x * 0.5
    next_y = torch.round(y1) + dir_y * 0.5
    fin_x = torch.zeros_like(dx_zero)
    fin_y = torch.zeros_like(dx_zero)
    dists, cells = [], []
    for _ in range(max_cross):
        done = fin_x & fin_y
        past_x = (((next_x > x2) & (dir_x == 1))
                  | ((next_x < x2) & (dir_x == -1))) & ~fin_x
        next_x = torch.where(past_x, x2, next_x)
        past_y = (((next_y > y2) & (dir_y == 1))
                  | ((next_y < y2) & (dir_y == -1))) & ~fin_y
        next_y = torch.where(past_y, y2, next_y)

        # is the next crossing an x- or a y-boundary
        next_x_yval = m * next_x + c
        next_y_xval = (next_y - c) / m_safe
        d_xcross = (x1 - next_x) ** 2 + (y1 - next_x_yval) ** 2
        d_ycross = (x1 - next_y_xval) ** 2 + (y1 - next_y) ** 2
        take_x = ~dx_zero & (m_zero | (d_xcross < d_ycross))
        nxv = torch.where(dx_zero, x1,
                          torch.where(take_x, next_x, next_y_xval))
        nyv = torch.where(dx_zero, next_y,
                          torch.where(take_x, next_x_yval, next_y))
        next_x = torch.where(take_x, next_x + dir_x, next_x)
        next_y = torch.where(~take_x, next_y + dir_y, next_y)

        x_pos = torch.clamp(torch.round((prev_x + nxv) / 2).to(torch.int64),
                            0, X - 1)
        y_pos = torch.clamp(torch.round((prev_y + nyv) / 2).to(torch.int64),
                            0, Z - 1)
        dist = model.dnx * torch.sqrt((prev_x - nxv) ** 2
                                      + (prev_y - nyv) ** 2)
        dists.append(torch.where(done, 0.0, dist))
        cells.append(y_pos * X + x_pos)
        prev_x = torch.where(done, prev_x, nxv)
        prev_y = torch.where(done, prev_y, nyv)
        fin_x = fin_x | (past_x & ~done)
        fin_y = fin_y | (past_y & ~done)
    row = mat_flat[torch.stack(cells)]
    eff = torch.remainder(row[..., 0] - angle[None], 180.0)
    vel = _group_velocity_cell(model, row, eff)
    return _sum_in_order(torch.stack(dists) / vel)


def _simpson_time(model, mat_flat, x1, y1, x2, y2, subgrid_size, fracs,
                  weights):
    """Segment time from slowness samples at ``fracs`` along the segment,
    combined with ``weights`` (added in sample order)."""
    Z, X = model.shape
    s = _scalar(model, subgrid_size)
    ddx = x2 - x1
    ddy = y2 - y1
    angle = _angle(ddx, ddy)
    dist = torch.sqrt(ddx * ddx + ddy * ddy) / s
    acc = None
    for fr, w in zip(fracs, weights):
        xm = x1 + ddx * fr
        ym = y1 + ddy * fr
        xi = torch.clamp(torch.round(xm / s).to(torch.int64), 0, X - 1)
        yi = torch.clamp(torch.round(ym / s).to(torch.int64), 0, Z - 1)
        row = mat_flat[yi * X + xi]
        eff = torch.remainder(row[..., 0] - angle, 180.0)
        term = w * (1.0 / _group_velocity_cell(model, row, eff))
        acc = term if acc is None else acc + term
    return model.dnx * dist * acc


def segment_time_quad(model, mat_flat, x1, y1, x2, y2, subgrid_size):
    """5-point composite-Simpson segment time (t = 0, 1/4, 1/2, 3/4, 1)."""
    return _simpson_time(
        model, mat_flat, x1, y1, x2, y2, subgrid_size,
        fracs=(0.0, 0.25, 0.5, 0.75, 1.0),
        weights=(1 / 12.0, 4 / 12.0, 2 / 12.0, 4 / 12.0, 1 / 12.0),
    )


def segment_time_quad3(model, mat_flat, x1, y1, x2, y2, subgrid_size):
    """3-point Simpson segment time (endpoints + midpoint, (1, 4, 1)/6)."""
    return _simpson_time(
        model, mat_flat, x1, y1, x2, y2, subgrid_size,
        fracs=(0.0, 0.5, 1.0), weights=(1 / 6.0, 4 / 6.0, 1 / 6.0),
    )


def ray_times_plain(model, mat_flat, ray_x, ray_y, lengths, subgrid_size,
                    max_cross: int = 16):
    """Plain twin of the ray-times kernel: see ``ray_times``."""
    R, P = ray_x.shape
    seg_t = segment_time(model, mat_flat, ray_x[:, :-1], ray_y[:, :-1],
                         ray_x[:, 1:], ray_y[:, 1:], subgrid_size, max_cross)
    idx = torch.arange(P - 1, device=ray_x.device)
    mask = (idx[None, :] + 1) < lengths[:, None]
    return torch.sum(torch.where(mask, seg_t, 0.0), dim=1)


def ray_times(model, mat_flat, ray_x, ray_y, lengths, subgrid_size,
              max_cross: int = 16):
    """Travel time along padded ray polylines (R, P): segment i counts when
    i + 1 < lengths.  K3 with no waves on CUDA tensors, ``ray_times_plain``
    on CPU tensors."""
    return cuda_rays.ray_times(model, mat_flat, ray_x, ray_y, lengths,
                               subgrid_size, max_cross)


def relax_wave_plain(model, mat_flat, xs, ys, lengths, subgrid_size,
                     parity: int, h: float, max_cross: int = 12,
                     quad: bool | int = False):
    """Plain twin of the relax-wave kernel: the interior vertices of
    ``parity`` below ``lengths - 1`` move along the perpendicular of their
    local chord to the minimum of a parabola through three scored
    offsets (-h, 0, h); every other vertex stays."""
    P = xs.shape[1]
    vidx = torch.arange(1, P - 1, device=xs.device)

    def seg(ax, ay, bx, by):
        if quad:
            fn = segment_time_quad3 if quad == 3 else segment_time_quad
            return fn(model, mat_flat, ax, ay, bx, by, subgrid_size)
        return segment_time(model, mat_flat, ax, ay, bx, by, subgrid_size,
                            max_cross)

    px, py = xs[:, :-2], ys[:, :-2]
    cx, cy = xs[:, 1:-1], ys[:, 1:-1]
    nx, ny = xs[:, 2:], ys[:, 2:]
    tx = nx - px
    ty = ny - py
    nrm = torch.sqrt(tx * tx + ty * ty)
    nrm = torch.where(nrm == 0.0, 1.0, nrm)
    ux = -ty / nrm
    uy = tx / nrm
    cands_x = torch.stack([cx, cx - ux * h, cx + ux * h])
    cands_y = torch.stack([cy, cy - uy * h, cy + uy * h])
    c0, cm, cp = (seg(px[None], py[None], cands_x, cands_y)
                  + seg(cands_x, cands_y, nx[None], ny[None]))
    d1 = cm - c0
    d3 = cp - c0
    ssum = d1 + d3
    convex = ssum > 0.0
    ssafe = torch.where(convex, ssum, 1.0)
    off = torch.clamp((d1 - d3) / (2.0 * ssafe), -1.0, 1.0) * h
    ends = torch.where(cm < cp, _full(cm, -h), _full(cm, h))
    better = torch.minimum(cm, cp) < c0
    off = torch.where(convex, off, torch.where(better, ends, 0.0))
    move = (((vidx[None, :] % 2) == parity)
            & (vidx[None, :] < (lengths - 1)[:, None]))
    off = torch.where(move, off, 0.0)
    xs = torch.cat([xs[:, :1], cx + ux * off, xs[:, -1:]], 1)
    ys = torch.cat([ys[:, :1], cy + uy * off, ys[:, -1:]], 1)
    return xs, ys


def relax_rays(model, mat_flat, ray_x, ray_y, lengths, subgrid_size,
               iters: int = 2, span: float | None = None,
               max_cross: int = 12, quad: bool | int = False):
    """Parallel Fermat relaxation of ray polylines: each interior vertex
    moves along the perpendicular of its local chord to minimise
    seg(prev, v) + seg(v, next), in odd then even waves (``iters`` times).
    ``quad`` scores with Simpson (3 = 3-point), else the exact integrator.
    All waves are one kernel launch on CUDA tensors, ``relax_wave_plain``
    wave by wave on CPU tensors."""
    if ray_x.shape[1] < 3 or iters <= 0:
        return ray_x, ray_y
    xs, ys, _ = cuda_rays.relax_and_times(
        model, mat_flat, ray_x, ray_y, lengths, subgrid_size, 2 * iters,
        h=span, relax_cross=max_cross, quad=quad, times=False)
    return xs, ys


def relax_and_times_plain(model, mat_flat, xs, ys, lengths, subgrid_size,
                          waves: int = 0, first_parity: int = 1,
                          h: float | None = None, relax_cross: int = 12,
                          quad: bool | int = False, times_cross: int = 16,
                          times: bool = True):
    """Plain twin of K3: ``waves`` waves of ``relax_wave_plain`` of
    alternating parity, the first of ``first_parity`` (``h`` defaults to
    ``subgrid_size``), then, with ``times``, ``ray_times_plain`` of the
    result.  Returns (xs, ys, times or None)."""
    h = float(subgrid_size) if h is None else float(h)
    for w in range(waves):
        xs, ys = relax_wave_plain(model, mat_flat, xs, ys, lengths,
                                  subgrid_size, (first_parity + w) % 2, h,
                                  relax_cross, quad)
    t = (ray_times_plain(model, mat_flat, xs, ys, lengths, subgrid_size,
                         times_cross) if times else None)
    return xs, ys, t


def march_plain(model: gridlib.Model, mat_flat, rec_ttf, ttf_index,
                source_xy, receiver_xy, spec: MarchSpec):
    """Plain twin of the march kernel.  Returns (bx, by, length, reason,
    steps): padded (R, max_steps + 2) polylines with the receiver
    appended, their lengths, why each ray ended (0 arrived or out of
    steps, 1 its plane left the grid, 2 its travel time rose) and the
    number of steps each ray took before it was done."""
    global PLAIN_STEPS
    Z, X = model.shape
    s, k_step, K = spec.s, spec.k_step, spec.K
    dt = model.dtype
    dev = model.device
    R = source_xy.shape[0]
    rows, cols = (Z - 1) * s + 1, (X - 1) * s + 1
    P = spec.max_steps + 2
    sd = spec.plane_dist * s + 1
    sd2 = (spec.plane_dist - 1) * s + 1
    s_t = _scalar(model, s)
    stride_t = _scalar(model, spec.stride)
    sqrt2 = _scalar(model, math.sqrt(2.0))

    src_x = source_xy[:, 0].to(dt)
    src_y = source_xy[:, 1].to(dt)
    rec_x = receiver_xy[:, 0].to(dt)
    rec_y = receiver_xy[:, 1].to(dt)

    TZ, TX = rec_ttf.shape[-2], rec_ttf.shape[-1]
    flat_all = rec_ttf.reshape(-1)
    t_off = (ttf_index * (TZ * TX) if rec_ttf.dim() == 3
             else torch.zeros_like(ttf_index))

    def sample_b(x, y):
        off = t_off.reshape(t_off.shape + (1,) * (x.dim() - 1))
        cx = torch.clamp(x / s_t, 0.0, TX - 1.0)
        cy = torch.clamp(y / s_t, 0.0, TZ - 1.0)
        x0 = torch.clamp(torch.floor(cx).to(torch.int64), 0, TX - 2)
        y0 = torch.clamp(torch.floor(cy).to(torch.int64), 0, TZ - 2)
        fx = cx - x0.to(dt)
        fy = cy - y0.to(dt)
        base = off + y0 * TX + x0
        v0, v1 = flat_all[base], flat_all[base + 1]
        v2, v3 = flat_all[base + TX], flat_all[base + TX + 1]
        return (v0 * (1 - fy) * (1 - fx) + v1 * (1 - fy) * fx
                + v2 * fy * (1 - fx) + v3 * fy * fx)

    def score(last_x, last_y, px, py):
        if spec.scorer == cuda_rays.WALK:
            return _segment_time_walk(model, mat_flat, last_x, last_y, px,
                                      py, s, spec.in_cross)
        fn = (segment_time_quad3 if spec.scorer == cuda_rays.SIMPSON3
              else segment_time_quad)
        return fn(model, mat_flat, last_x, last_y, px, py, s)

    ridx = torch.arange(R, device=dev)
    kcol = torch.arange(K, device=dev)
    kw = spec.stride * torch.arange(K, dtype=dt, device=dev)

    def pick(d, v0, v1, v2, v3):
        d = d.reshape(d.shape + (1,) * (v0.dim() - d.dim()))
        return torch.where(d == 0, v0, torch.where(
            d == 1, v1, torch.where(d == 2, v2, v3)))

    def step(state):
        (last_x, last_y, vec_x, vec_y, bx, by, length, done, reason,
         tt_last_pt, steps) = state
        steps = steps + (~done).to(torch.int64)
        near2 = (last_x - rec_x) ** 2 + (last_y - rec_y) ** 2
        snap = near2 < (4.0 * s) ** 2
        vec_x = torch.where(snap, rec_x - last_x, vec_x)
        vec_y = torch.where(snap, rec_y - last_y, vec_y)
        off = torch.where(near2 < ((k_step + 3.0) * s) ** 2,
                          _full(near2, float(spec.near_step * s)),
                          _full(near2, float(k_step * s)))

        dir_index = _argmax_first([
            torch.abs(vec_x),
            torch.abs(vec_x + vec_y) / sqrt2,
            torch.abs(vec_y),
            torch.abs(vec_x - vec_y) / sqrt2,
        ])

        rl_x = torch.round(last_x)
        rl_y = torch.round(last_y)
        offx = torch.where(vec_x > 0, off, -off)
        c0 = rl_x + offx
        oob0 = (c0 < 0) | (c0 >= cols)
        lo0 = torch.clamp_min(rl_y - sd, 0.0)
        hi0 = torch.clamp_max(rl_y + sd, rows - 1.0)

        c1 = rl_x + rl_y + offx
        base1 = torch.clamp_min(c1 - (rows - 1.0), 0.0)
        top1 = torch.clamp_max(c1, cols - 1.0)
        lo1 = torch.where(vec_x > 0, torch.maximum(base1, rl_x - sd2),
                          torch.maximum(base1, c1 - rl_y - sd2))
        hi1 = torch.where(vec_x > 0, torch.minimum(top1, c1 - rl_y + sd2),
                          torch.minimum(top1, rl_x + sd2))

        c2 = rl_y + torch.where(vec_y > 0, off, -off)
        oob2 = (c2 < 0) | (c2 >= rows)
        lo2 = torch.clamp_min(rl_x - sd, 0.0)
        hi2 = torch.clamp_max(rl_x + sd, cols - 1.0)

        c3 = rl_y - rl_x + torch.where(vec_x < 0, off, -off)
        base3 = torch.clamp_min(-c3, 0.0)
        top3 = torch.clamp_max((rows - 1.0) - c3, cols - 1.0)
        lo3 = torch.where(vec_x < 0, torch.maximum(base3, rl_y - c3 - sd2),
                          torch.maximum(base3, rl_x - sd2))
        hi3 = torch.where(vec_x < 0, torch.minimum(top3, rl_x + sd2),
                          torch.minimum(top3, rl_y - c3 + sd2))

        lo = pick(dir_index, lo0, lo1, lo2, lo3)
        hi = pick(dir_index, hi0, hi1, hi2, hi3)
        w = torch.minimum(lo[:, None] + kw[None, :], hi[:, None])
        n_k = torch.clamp(((hi - lo) / stride_t).to(torch.int64) + 1, 1, K)

        zw = 0 * w
        px = pick(dir_index, c0[:, None] + zw, w, w, w)
        py = pick(dir_index, w, c1[:, None] - w, c2[:, None] + zw,
                  w + c3[:, None])
        tt_plane = sample_b(px, py)
        seg = score(last_x[:, None], last_y[:, None], px, py)
        TT = tt_plane + seg
        col = kcol[None, :]
        TT = torch.where(col < n_k[:, None], TT, _BIG)

        last_col = torch.clamp_max(n_k - 1, K - 1)
        tt_first = TT[:, 0]
        tt_last = TT[ridx, last_col]
        first_wins = tt_first < tt_last
        best_val = torch.where(first_wins, tt_first, tt_last)
        best_pos = torch.where(first_wins, 0.0, last_col.to(dt))

        # interior local minima with quadratic refinement (differences
        # first: the vertex of a 3-point parabola with t2 minimal lies in
        # [-1/2, 1/2])
        t1 = TT[:, :-2]
        t2 = TT[:, 1:-1]
        t3 = TT[:, 2:]
        is_min = (t1 >= t2) & (t2 <= t3) & (col[:, :-2] + 2 < n_k[:, None])
        d1 = t1 - t2
        d3 = t3 - t2
        ssum = d1 + d3
        flat = ssum <= 0
        ssafe = torch.where(flat, 1.0, ssum)
        o = torch.clamp((d1 - d3) / (2.0 * ssafe), -0.5, 0.5)
        o = torch.where(flat, 0.0, o)
        val = t2 + (0.5 * ssum) * o * o + (0.5 * (d3 - d1)) * o
        pos = o + (col[:, :-2] + 1).to(dt)
        val = torch.where(is_min, val, _BIG)
        jbest = _argmin_first(val)
        v_loc = val[ridx, jbest]
        p_loc = pos[ridx, jbest]
        best_pos = torch.where(v_loc < best_val, p_loc, best_pos)

        wq = lo + torch.minimum(best_pos * spec.stride, hi - lo)
        new_x = pick(dir_index, c0, wq, wq, wq)
        new_y = pick(dir_index, wq, c1 - wq, c2, wq + c3)

        plane_oob = ((dir_index == 0) & oob0) | ((dir_index == 2) & oob2)
        if k_step == 1:
            tt_new_pt = sample_b(torch.round(new_x), torch.round(new_y))
        else:
            col_b = torch.clamp(torch.round(best_pos).to(torch.int64), 0,
                                K - 1)
            tt_new_pt = tt_plane[ridx, col_b]
        increasing = tt_last_pt < tt_new_pt

        reason = torch.where(
            done, reason,
            torch.where(plane_oob, 1, torch.where(increasing, 2, reason)))
        stop = done | plane_oob | increasing
        add = ~stop

        bx[ridx, length] = torch.where(add, new_x, bx[ridx, length])
        by[ridx, length] = torch.where(add, new_y, by[ridx, length])
        vec_x = torch.where(add, new_x - last_x, vec_x)
        vec_y = torch.where(add, new_y - last_y, vec_y)
        last_x = torch.where(add, new_x, last_x)
        last_y = torch.where(add, new_y, last_y)
        length = torch.where(add, length + 1, length)
        tt_last_pt = torch.where(add, tt_new_pt, tt_last_pt)

        arrived = ((last_x - rec_x) ** 2 + (last_y - rec_y) ** 2
                   <= (1.6 * s) ** 2)
        done = stop | arrived
        return (last_x, last_y, vec_x, vec_y, bx, by, length, done, reason,
                tt_last_pt, steps)

    bx = torch.zeros((R, P), dtype=dt, device=dev)
    by = torch.zeros((R, P), dtype=dt, device=dev)
    bx[:, 0] = src_x
    by[:, 0] = src_y
    arrived0 = (src_x - rec_x) ** 2 + (src_y - rec_y) ** 2 <= (1.6 * s) ** 2
    tt_src = sample_b(torch.round(src_x), torch.round(src_y))
    zeros = torch.zeros(R, dtype=torch.int64, device=dev)
    state = (src_x, src_y, rec_x - src_x, rec_y - src_y, bx, by,
             torch.ones(R, dtype=torch.int64, device=dev), arrived0, zeros,
             tt_src, zeros)
    k = 0
    while k < spec.max_steps and not bool(state[7].all()):
        state = step(state)
        PLAIN_STEPS += 1
        k += 1
    _, _, _, _, bx, by, length, _, reason, _, steps = state

    # append the receiver
    bx[ridx, length] = rec_x
    by[ridx, length] = rec_y
    return bx, by, length + 1, reason, steps


def march_spec(model: gridlib.Model, subgrid_size: int,
               max_steps: int | None, max_cross: int, step_scale: int,
               quad_vel: bool | int, cand_stride: float, plane_dist: int,
               near_step: int) -> MarchSpec:
    """The march's static shape from ``trace_rays``' knobs."""
    Z, X = model.shape
    s = int(subgrid_size)
    k_step = int(step_scale)
    if max_steps is None:
        max_steps = -(-5 * (Z + X) // k_step)
    plane_dist = int(plane_dist)
    stride = float(cand_stride)
    K = int(math.ceil(2 * (plane_dist * s + 1) / stride)) + 1
    # the walk must resolve every crossing of the longest candidate
    # segment, which spans about step + 2 cells per axis
    in_cross = (max_cross if k_step == 1
                else max(max_cross, 2 * (k_step + 2) + 4))
    scorer = (cuda_rays.WALK if not quad_vel
              else cuda_rays.SIMPSON3 if quad_vel == 3
              else cuda_rays.SIMPSON5)
    return MarchSpec(s, k_step, int(near_step), plane_dist, stride, K,
                     int(max_steps), scorer, int(in_cross))


def trace_rays(
    model: gridlib.Model,
    rec_ttf,
    ttf_index,
    source_xy,
    receiver_xy,
    subgrid_size: int,
    mode: str = "grid",
    max_steps: int | None = None,
    max_cross: int = 16,
    exact_materials: bool = False,
    step_scale: int = 1,
    quad_vel: bool | int = False,
    return_reason: bool = False,
    relax_iters: int = 0,
    cand_stride: float = 1.0,
    relax_quad: bool | int = True,
    fast_step_scale: int = 0,
    plane_dist: int = 3,
    near_step: int = 1,
):
    """March rays from ``source_xy`` to ``receiver_xy`` (R, 2) fine-grid
    coordinates through the receiver fields ``rec_ttf`` (T, Z, X) on the
    model grid, sampled bilinearly (``mode="interp"``); ``ttf_index`` (R,)
    picks each ray's field.  Returns (ray_x, ray_y, lengths, times[,
    reason]): padded (R, max_steps + 2) polylines including source and
    receiver.  See the JAX package's trace_rays for the knobs.  Inputs are
    moved to the model's device; there the march is one kernel launch and
    the relaxation waves with the ray times another
    (``ops/cuda_rays.py``).  Not ported yet: ``mode="grid"``,
    ``fast_step_scale`` and ``exact_materials``."""
    if mode != "interp":
        raise NotImplementedError(f"trace_rays mode={mode!r}")
    if fast_step_scale:
        raise NotImplementedError("trace_rays fast_step_scale")
    mat_flat = _material_flat(model, exact_materials)
    dev = model.device
    spec = march_spec(model, subgrid_size, max_steps, max_cross, step_scale,
                      quad_vel, cand_stride, plane_dist, near_step)
    rec_ttf = torch.as_tensor(rec_ttf).to(dev)
    ttf_index = torch.as_tensor(ttf_index)
    n_fields = rec_ttf.shape[0] if rec_ttf.dim() == 3 else 1
    # checked where the indices lie: for indices on the host (the facade's)
    # this costs no wait; for indices on the card it is the ray phase's one
    # host read, ahead of the march (the kernel does not check)
    if ttf_index.numel() and (int(ttf_index.min()) < 0
                              or int(ttf_index.max()) >= n_fields):
        raise ValueError("ttf_index out of range of the field stack")
    ttf_index = ttf_index.to(dev).to(torch.int64)
    source_xy = torch.as_tensor(source_xy).to(dev)
    receiver_xy = torch.as_tensor(receiver_xy).to(dev)

    bx, by, length, reason, _ = cuda_rays.march(
        model, mat_flat, rec_ttf, ttf_index, source_xy, receiver_xy, spec)

    final_cross = max(-(-max_cross // 2) + 1, spec.k_step + 4)
    bx, by, times = cuda_rays.relax_and_times(
        model, mat_flat, bx, by, length, spec.s, 2 * max(relax_iters, 0),
        relax_cross=final_cross, quad=relax_quad, times_cross=final_cross)
    if return_reason:
        return bx, by, length, times, reason
    return bx, by, length, times
