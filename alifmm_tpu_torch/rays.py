"""Batched Fermat ray tracing through receiver travel-time fields.

Counterpart of ``alifmm_tpu/rays.py``: the plane-search march of
``trace_rays`` with Simpson or crossing-walk candidate scoring, the
characteristic descent of ``trace_rays_descent`` (a step along the group
direction from the field's gradient and the model's skew table, with an
optional scored window), ``trace_rays_auto`` (the descent, certified
against the field's first arrival, with the plane search as fallback),
even/odd-wave Fermat relaxation (``relax_rays``), exact sorted-crossing
time integration (``ray_times``/``segment_time``) and
``split_at_cell_boundaries``.  Fields are sampled bilinearly
on the model grid (``mode="interp"``) or at the nearest point of the
refined grid (``mode="grid"``); materials come from the unified curve
table or, with ``exact_materials`` (and for models without curve
indices), from the per-sample Christoffel solve; ``fast_step_scale``
takes long strides where ``_uniform_mask`` finds the medium uniform.

On CUDA tensors the marches and the relaxation with the ray times run as
hand-written kernels (``ops/cuda_rays.py``, ``csrc/rays.cu`` and
``csrc/descent.cu``): one launch marches every ray to its end with no host
read per step, one more relaxes every ray and adds up its time.  This
module holds their plain PyTorch twins -- ``march_plain`` and
``descent_plain`` (Python loops over steps, vectorised over rays and
candidates, one host read per step), ``relax_and_times_plain`` (the
waves of ``relax_wave_plain``, then ``ray_times_plain``) and the segment
integrators -- which the wrappers take for CPU tensors and which the
kernels are held against on the card.  ``mod180`` states the kernels'
floor-mod by 180, which gives ``torch.remainder``'s bits.
``PLAIN_STEPS`` counts plain march steps of both marches.

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
from .ops._math import sqrt
from .utils.profiling import span

__all__ = ["segment_time", "segment_time_quad", "segment_time_quad3",
           "ray_times", "relax_rays", "trace_rays", "trace_rays_descent",
           "trace_rays_auto", "split_at_cell_boundaries", "MarchSpec",
           "march_spec", "march_plain", "DescentSpec", "descent_spec",
           "descent_plain", "relax_wave_plain", "ray_times_plain",
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
    ``WALK``) and the walk's crossing budget; ``k_fast`` model cells per
    step where the medium is uniform (0: never), and ``grid``: the fields
    lie on the refined grid and are read at the nearest point."""

    s: int
    k_step: int
    near_step: int
    plane_dist: int
    stride: float
    K: int
    max_steps: int
    scorer: int
    in_cross: int
    k_fast: int
    grid: bool


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
    """Per-cell rows for the segment integrators, built on the model's
    device with no host read.  Fast path: (Z*X, 4) rows (veln, vel_map,
    unified-curve index, 0) -- the JAX package's three columns, padded so
    that a kernel reads a row in one aligned load.  ``exact=True``, or a
    model without curve indices: (Z*X, 8) rows (veln, velpn, vel_map,
    c22, c23, c33, c44, rho), for the group table or the Christoffel
    solve per sample (two aligned loads of 4)."""
    Z, X = model.shape
    if exact or model.ray_curve_idx is None:
        cols = [model.veln, model.velpn.to(model.dtype), model.vel_map]
        cols += [model.stif[..., c] for c in range(5)]
        return torch.stack(cols, dim=-1).reshape(Z * X, 8)
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
    """Group velocity at effective angle ``eff`` for gathered cell rows:
    from the unified per-cell curve table (4-column rows), or (8-column
    rows) from the group table where velpn != 0 and by the Christoffel
    solve elsewhere, when the model has stiffness."""
    if mat_row.shape[-1] == 4:
        return mats.interp_table_gather(model.ray_curves, eff,
                                        mat_row[..., 2].to(torch.int64),
                                        mat_row[..., 1])
    velpn, vel_map = mat_row[..., 1], mat_row[..., 2]
    v_tab = mats.interp_table_gather(model.group_tab, eff,
                                     velpn.to(torch.int64), vel_map)
    if not model.has_stif:
        return v_tab
    v_chr = mats.group_velocity_christoffel(
        eff, *(mat_row[..., c] for c in range(3, 8)), vel_map)
    return torch.where(velpn != 0, v_tab, v_chr)


def _uniform_mask(model: gridlib.Model, radius: int):
    """Per-cell mask, True where every material field is constant within a
    Chebyshev ``radius`` (model cells): the medium is locally homogeneous,
    so a straight segment through the neighbourhood is Fermat-optimal.
    Separable max and min pools of each field in float32 with "SAME"
    edges (cells beyond the grid do not count), on the model's device."""
    k = 2 * radius + 1

    def pool_max(f):
        f = torch.nn.functional.max_pool2d(f, (k, 1), 1, (radius, 0))
        return torch.nn.functional.max_pool2d(f, (1, k), 1, (0, radius))

    def uniform(f):
        f = f.to(torch.float32)[None, None]
        return (pool_max(f) == -pool_max(-f))[0, 0]

    ok = uniform(model.veln) & uniform(model.velpn) & uniform(model.vel_map)
    if model.has_stif:
        for c in range(5):
            ok &= uniform(model.stif[..., c])
    return ok


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
    length = sqrt(dx * dx + dy * dy)

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
        dist = model.dnx * sqrt((prev_x - nxv) ** 2
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
    dist = sqrt(ddx * ddx + ddy * ddy) / s
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
    nrm = sqrt(tx * tx + ty * ty)
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
                source_xy, receiver_xy, spec: MarchSpec, fast=None):
    """Plain twin of the march kernel.  ``fast``: the (Z*X,) uniform mask
    when ``spec.k_fast`` > 0.  Returns (bx, by, length, reason, steps):
    padded (R, max_steps + 2) polylines with the receiver appended, their
    lengths, why each ray ended (0 arrived or out of steps, 1 its plane
    left the grid, 2 its travel time rose) and the number of steps each
    ray took before it was done."""
    global PLAIN_STEPS
    Z, X = model.shape
    s, k_step, K, k_fast = spec.s, spec.k_step, spec.K, spec.k_fast
    dt = model.dtype
    dev = model.device
    R = source_xy.shape[0]
    TZ, TX = rec_ttf.shape[-2], rec_ttf.shape[-1]
    if spec.grid:
        rows, cols = TZ, TX
    else:
        rows, cols = (Z - 1) * s + 1, (X - 1) * s + 1
    if k_fast > 0 and fast is None:
        raise ValueError("a march with fast_step_scale needs the uniform "
                         "mask")
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

    flat_all = rec_ttf.reshape(-1)
    t_off = (ttf_index * (TZ * TX) if rec_ttf.dim() == 3
             else torch.zeros_like(ttf_index))

    def sample_b(x, y):
        off = t_off.reshape(t_off.shape + (1,) * (x.dim() - 1))
        if spec.grid:
            xi = torch.clamp(torch.round(x).to(torch.int64), 0, TX - 1)
            yi = torch.clamp(torch.round(y).to(torch.int64), 0, TZ - 1)
            return flat_all[off + yi * TX + xi]
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
        off_far = _full(near2, float(k_step * s))
        if k_fast > 0:
            # the long stride where the medium is uniform around the point
            # and the receiver is beyond its reach
            xi_f = torch.clamp(torch.round(last_x / s_t).to(torch.int64), 0,
                               X - 1)
            yi_f = torch.clamp(torch.round(last_y / s_t).to(torch.int64), 0,
                               Z - 1)
            fast_here = fast[yi_f * X + xi_f]
            far = near2 >= ((k_fast + 3.0) * s) ** 2
            off_far = torch.where(fast_here & far,
                                  _full(near2, float(k_fast * s)), off_far)
        off = torch.where(near2 < ((k_step + 3.0) * s) ** 2,
                          _full(near2, float(spec.near_step * s)), off_far)

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
               near_step: int, fast_step_scale: int = 0,
               mode: str = "interp") -> MarchSpec:
    """The march's static shape from ``trace_rays``' knobs."""
    if mode not in ("grid", "interp"):
        raise ValueError(f"trace_rays mode {mode!r}: 'grid' or 'interp'")
    Z, X = model.shape
    s = int(subgrid_size)
    k_step = int(step_scale)
    k_fast = int(fast_step_scale)
    k_eff = max(k_step, k_fast)
    if max_steps is None:
        max_steps = -(-5 * (Z + X) // k_step)
    plane_dist = int(plane_dist)
    stride = float(cand_stride)
    K = int(math.ceil(2 * (plane_dist * s + 1) / stride)) + 1
    # the walk must resolve every crossing of the longest candidate
    # segment, which spans about step + 2 cells per axis
    in_cross = (max_cross if k_eff == 1
                else max(max_cross, 2 * (k_eff + 2) + 4))
    scorer = (cuda_rays.WALK if not quad_vel
              else cuda_rays.SIMPSON3 if quad_vel == 3
              else cuda_rays.SIMPSON5)
    return MarchSpec(s, k_step, int(near_step), plane_dist, stride, K,
                     int(max_steps), scorer, int(in_cross), k_fast,
                     mode == "grid")


def _read_int(t):
    """``int(t)`` of a 0-d tensor: on the card a blocking read, the range
    ``alifmm.rays.read``."""
    if not t.is_cuda:
        return int(t)
    with span("rays.read"):
        return int(t)


def _ray_inputs(model, rec_ttf, ttf_index, source_xy, receiver_xy):
    """A tracer's inputs on the model's device, the field indices as int64
    and checked against the stack where they lie: for indices on the host
    (the facade's) this costs no wait; for indices on the card it is the
    ray phase's one host read, ahead of the march (the kernels do not
    check)."""
    dev = model.device
    rec_ttf = torch.as_tensor(rec_ttf).to(dev)
    ttf_index = torch.as_tensor(ttf_index)
    n_fields = rec_ttf.shape[0] if rec_ttf.dim() == 3 else 1
    if ttf_index.numel() and (_read_int(ttf_index.min()) < 0
                              or _read_int(ttf_index.max()) >= n_fields):
        raise ValueError("ttf_index out of range of the field stack")
    return (rec_ttf, ttf_index.to(dev).to(torch.int64),
            torch.as_tensor(source_xy).to(dev),
            torch.as_tensor(receiver_xy).to(dev))


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
    coordinates through the receiver fields ``rec_ttf`` (T, ...):
    ``mode="grid"`` (the reference's path) takes fields on the refined
    grid of ``subgrid_size`` and reads the nearest fine point;
    ``mode="interp"`` takes fields on the model grid and samples them
    bilinearly.  ``ttf_index`` (R,) picks each ray's field.  Returns
    (ray_x, ray_y, lengths, times[, reason]): padded (R, max_steps + 2)
    polylines including source and receiver.  See the JAX package's
    trace_rays for the knobs.  Inputs are moved to the model's device;
    there the march is one kernel launch and the relaxation waves with the
    ray times another (``ops/cuda_rays.py``)."""
    mat_flat = _material_flat(model, exact_materials)
    spec = march_spec(model, subgrid_size, max_steps, max_cross, step_scale,
                      quad_vel, cand_stride, plane_dist, near_step,
                      fast_step_scale, mode)
    # the JAX radius: k_fast + 4 model cells, whatever plane_dist is
    fast = (_uniform_mask(model, spec.k_fast + 4).reshape(-1)
            if spec.k_fast > 0 else None)
    rec_ttf, ttf_index, source_xy, receiver_xy = _ray_inputs(
        model, rec_ttf, ttf_index, source_xy, receiver_xy)

    bx, by, length, reason, _ = cuda_rays.march(
        model, mat_flat, rec_ttf, ttf_index, source_xy, receiver_xy, spec,
        fast)

    final_cross = max(-(-max_cross // 2) + 1,
                      max(spec.k_step, spec.k_fast) + 4)
    bx, by, times = cuda_rays.relax_and_times(
        model, mat_flat, bx, by, length, spec.s, 2 * max(relax_iters, 0),
        relax_cross=final_cross, quad=relax_quad, times_cross=final_cross)
    if return_reason:
        return bx, by, length, times, reason
    return bx, by, length, times


def _sample_ttf(ttf, x, y, subgrid_size, mode, index=None):
    """The receiver field sampled at fine coordinates (x, y): in ``"grid"``
    mode the nearest point of the refined grid (round half to even), in
    ``"interp"`` mode bilinear on the model grid at (x, y) / s.  ``ttf``
    is one (Z, X) field, or a (T, Z, X) stack with ``index`` picking each
    point's field (read in place: the stack is not gathered)."""
    Z, X = ttf.shape[-2:]
    flat = ttf.reshape(-1)
    off = 0 if index is None else index * (Z * X)
    if mode == "grid":
        xi = torch.clamp(torch.round(x).to(torch.int64), 0, X - 1)
        yi = torch.clamp(torch.round(y).to(torch.int64), 0, Z - 1)
        return flat[off + yi * X + xi]
    v00, v01, v10, v11, fx, fy = _corners(flat, off, Z, X, x, y,
                                          _scalar_like(x, subgrid_size))
    return _bilinear(v00, v01, v10, v11, fx, fy)


def _sample_ttf_grad(ttf, x, y, subgrid_size, mode, index=None):
    """(T, dT/dx, dT/dy) at fine coordinates from the in-cell bilinear
    surface: on the model grid at (x, y) / s, or (``"grid"``) on the
    refined grid itself.  Derivatives are per fine cell.  ``ttf`` and
    ``index`` as in ``_sample_ttf``."""
    Z, X = ttf.shape[-2:]
    off = 0 if index is None else index * (Z * X)
    s = _scalar_like(x, 1.0 if mode == "grid" else subgrid_size)
    v00, v01, v10, v11, fx, fy = _corners(ttf.reshape(-1), off, Z, X, x, y,
                                          s)
    gx = ((1 - fy) * (v01 - v00) + fy * (v11 - v10)) / s
    gy = ((1 - fx) * (v10 - v00) + fx * (v11 - v01)) / s
    return _bilinear(v00, v01, v10, v11, fx, fy), gx, gy


def _scalar_like(t, v):
    return torch.full((), float(v), dtype=t.dtype, device=t.device)


def _corners(flat, off, Z, X, x, y, s):
    """The four field values around (x, y) / s in a flat (Z, X) field
    stack at element offset ``off``, and the fractions within the cell;
    ``s`` is a 0-d tensor."""
    cx = torch.clamp(x / s, 0.0, X - 1.0)
    cy = torch.clamp(y / s, 0.0, Z - 1.0)
    x0 = torch.clamp(torch.floor(cx).to(torch.int64), 0, X - 2)
    y0 = torch.clamp(torch.floor(cy).to(torch.int64), 0, Z - 2)
    fx = cx - x0.to(cx.dtype)
    fy = cy - y0.to(cy.dtype)
    base = off + y0 * X + x0
    return (flat[base], flat[base + 1], flat[base + X], flat[base + X + 1],
            fx, fy)


def _bilinear(v00, v01, v10, v11, fx, fy):
    return (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
            + v10 * fy * (1 - fx) + v11 * fy * fx)


class DescentSpec(typing.NamedTuple):
    """Static shape of a descent march: fine cells per model cell ``s``,
    model cells per step far from the receiver ``step_scale``, the step
    budget, the scored window (``score_k`` candidates ``score_stride``
    model cells apart; 0: none) and ``grid``: the fields lie on the
    refined grid (the gradient is bilinear on it either way)."""

    s: int
    step_scale: float
    max_steps: int
    score_k: int
    score_stride: float
    grid: bool


def descent_spec(model: gridlib.Model, subgrid_size: int,
                 max_steps: int | None, step_scale: float, score_k: int,
                 score_stride: float, mode: str = "interp") -> DescentSpec:
    """The descent march's static shape from ``trace_rays_descent``'s
    knobs.  An even ``score_k`` raises: the improve-gate scores the
    window's centre candidate, which an even window lacks."""
    if score_k > 0 and score_k % 2 == 0:
        raise ValueError(f"score_k must be odd (got {score_k})")
    if mode not in ("grid", "interp"):
        raise ValueError(f"trace_rays_descent mode {mode!r}: 'grid' or "
                         f"'interp'")
    if model.ray_curve_idx is None or model.ray_skew is None:
        raise ValueError("the descent needs a model with ray curves and "
                         "skew tables (grid.make_model builds them)")
    Z, X = model.shape
    if max_steps is None:
        max_steps = int(-(-5 * (Z + X) // max(1.0, float(step_scale))))
    return DescentSpec(int(subgrid_size), float(step_scale), int(max_steps),
                       int(score_k), float(score_stride), mode == "grid")


def descent_plain(model: gridlib.Model, mat_flat, rec_ttf, ttf_index,
                  source_xy, receiver_xy, spec: DescentSpec):
    """Plain twin of the descent kernel (K4).  Each step moves a ray
    against its group direction: the unit bilinear gradient of its field
    (the phase direction) turned by the skew of the model cell it is in
    (``model.ray_skew`` at the effective angle); ``step_scale`` model
    cells a step, one inside (step_scale + 3) of the receiver, straight at
    it inside 4, onto it when it is within the step.  With ``score_k``
    the point then moves across the step to the parabolic minimum of
    field + Simpson segment time over the window, where that beats the
    centre by more than 1e-3 of its segment time.  A ray ends when its
    gradient vanishes (reason 1), when it is within 1.6 model cells of
    the receiver, or after ``max_steps``.  Returns (bx, by, length,
    reason, steps) as ``march_plain`` does, the receiver appended."""
    global PLAIN_STEPS
    Z, X = model.shape
    s = spec.s
    dt, dev = model.dtype, model.device
    R = source_xy.shape[0]
    TZ, TX = rec_ttf.shape[-2:]
    if spec.grid:
        rows, cols = TZ, TX
    else:
        rows, cols = (Z - 1) * s + 1, (X - 1) * s + 1
    P = spec.max_steps + 2
    s_t = _scalar(model, s)
    s_grid = _scalar(model, 1.0 if spec.grid else s)
    one = _scalar(model, 1.0)
    h_far = spec.step_scale * s
    near_far2 = ((spec.step_scale + 3.0) * s) ** 2
    K = spec.score_k
    half = (K - 1) / 2.0
    lat_step = spec.score_stride * s

    src_x = source_xy[:, 0].to(dt)
    src_y = source_xy[:, 1].to(dt)
    rec_x = receiver_xy[:, 0].to(dt)
    rec_y = receiver_xy[:, 1].to(dt)
    flat_all = rec_ttf.reshape(-1)
    t_off = (ttf_index * (TZ * TX) if rec_ttf.dim() == 3
             else torch.zeros_like(ttf_index))
    mode = "grid" if spec.grid else "interp"
    field = ttf_index if rec_ttf.dim() == 3 else None
    veln_flat = model.veln.reshape(-1)
    cls_flat = model.ray_curve_idx.reshape(-1)
    ridx = torch.arange(R, device=dev)
    if K:
        lat = (torch.arange(K, dtype=dt, device=dev) - half) * lat_step

    def step(state):
        last_x, last_y, bx, by, length, done, reason, steps = state
        steps = steps + (~done).to(torch.int64)
        _, gx, gy = _sample_ttf_grad(rec_ttf, last_x, last_y, s, mode,
                                     field)
        gnorm = sqrt(gx * gx + gy * gy)
        stalled = gnorm <= 0.0
        gsafe = torch.where(stalled, 1.0, gnorm)
        nx, ny = gx / gsafe, gy / gsafe

        # the skew of the current cell turns the phase direction into the
        # group direction; the ray marches against it
        xi = torch.clamp(torch.round(last_x / s_t).to(torch.int64), 0, X - 1)
        yi = torch.clamp(torch.round(last_y / s_t).to(torch.int64), 0, Z - 1)
        cell = yi * X + xi
        phi = veln_flat[cell] - torch.atan2(gy, gx) * _RAD2DEG
        d_mat = mats.interp_table_gather(model.ray_skew, phi, cls_flat[cell],
                                         one)
        dg = -d_mat * (math.pi / 180.0)
        cd, sd = torch.cos(dg), torch.sin(dg)
        dir_x = -(cd * nx - sd * ny)
        dir_y = -(cd * ny + sd * nx)

        dx_r = rec_x - last_x
        dy_r = rec_y - last_y
        near2 = dx_r * dx_r + dy_r * dy_r
        near = sqrt(near2)
        off = torch.where(near2 < near_far2, _full(near2, float(s)),
                          _full(near2, h_far))
        snap = near2 < (4.0 * s) ** 2
        nsafe = torch.where(near == 0, 1.0, near)
        dir_x = torch.where(snap, dx_r / nsafe, dir_x)
        dir_y = torch.where(snap, dy_r / nsafe, dir_y)
        hit = snap & (near <= off)

        new_x = torch.clamp(last_x + off * dir_x, 0.0, cols - 1.0)
        new_y = torch.clamp(last_y + off * dir_y, 0.0, rows - 1.0)
        if K:
            # the scored window across the step, centred on the point
            px, py = -dir_y, dir_x
            cx = torch.clamp(new_x[:, None] + lat[None, :] * px[:, None], 0.0,
                             cols - 1.0)
            cy = torch.clamp(new_y[:, None] + lat[None, :] * py[:, None], 0.0,
                             rows - 1.0)
            t_c = _bilinear(*_corners(flat_all, t_off[:, None], TZ, TX, cx,
                                      cy, s_grid))
            seg = segment_time_quad(model, mat_flat, last_x[:, None],
                                    last_y[:, None], cx, cy, s)
            score = t_c + seg
            kb = _argmin_first(score)
            s0 = score[ridx, kb]
            sm = score[ridx, torch.clamp_min(kb - 1, 0)]
            sp = score[ridx, torch.clamp_max(kb + 1, K - 1)]
            den = sm - 2.0 * s0 + sp
            delta = torch.where(
                den > 0.0,
                0.5 * (sm - sp) / torch.where(den == 0.0, 1.0, den), 0.0)
            woff = (kb.to(dt) - half + torch.clamp(delta, -1.0, 1.0)) * lat_step
            # correct only where the window's minimum beats the centre by
            # more than the flat valley's noise; the snap stays straight
            improve = (score[:, K // 2] - s0) > 1e-3 * seg[:, K // 2]
            woff = torch.where(improve & ~snap, woff, 0.0)
            new_x = torch.clamp(new_x + woff * px, 0.0, cols - 1.0)
            new_y = torch.clamp(new_y + woff * py, 0.0, rows - 1.0)
        new_x = torch.where(hit, rec_x, new_x)
        new_y = torch.where(hit, rec_y, new_y)

        reason = torch.where(done, reason, torch.where(stalled, 1, reason))
        add = ~(done | stalled)
        bx[ridx, length] = torch.where(add, new_x, bx[ridx, length])
        by[ridx, length] = torch.where(add, new_y, by[ridx, length])
        last_x = torch.where(add, new_x, last_x)
        last_y = torch.where(add, new_y, last_y)
        length = torch.where(add, length + 1, length)
        arrived = ((last_x - rec_x) ** 2 + (last_y - rec_y) ** 2
                   <= (1.6 * s) ** 2)
        done = done | stalled | arrived
        return last_x, last_y, bx, by, length, done, reason, steps

    bx = torch.zeros((R, P), dtype=dt, device=dev)
    by = torch.zeros((R, P), dtype=dt, device=dev)
    bx[:, 0] = src_x
    by[:, 0] = src_y
    arrived0 = (src_x - rec_x) ** 2 + (src_y - rec_y) ** 2 <= (1.6 * s) ** 2
    zeros = torch.zeros(R, dtype=torch.int64, device=dev)
    state = (src_x, src_y, bx, by, torch.ones(R, dtype=torch.int64,
                                              device=dev),
             arrived0, zeros, zeros)
    k = 0
    while k < spec.max_steps and not bool(state[5].all()):
        state = step(state)
        PLAIN_STEPS += 1
        k += 1
    _, _, bx, by, length, _, reason, steps = state
    bx[ridx, length] = rec_x
    by[ridx, length] = rec_y
    return bx, by, length + 1, reason, steps


def trace_rays_descent(
    model: gridlib.Model,
    rec_ttf,
    ttf_index,
    source_xy,
    receiver_xy,
    subgrid_size: int,
    mode: str = "interp",
    max_steps: int | None = None,
    max_cross: int = 16,
    step_scale: float = 6.0,
    relax_iters: int = 2,
    relax_quad: bool | int = True,
    return_reason: bool = False,
    score_k: int = 0,
    score_stride: float = 1.0,
):
    """Characteristic-descent ray marching: each step follows the group
    direction that the receiver field's gradient and the model's skew
    table give (``descent_plain`` states the step), with an optional
    scored window of ``score_k`` (odd) candidates across it.  Then
    ``relax_iters`` odd-even pairs of Fermat relaxation waves and the
    exact ray times, with ``max(max_cross, int(2 * step_scale) + 6)``
    crossings a segment.  Same arguments and returns as ``trace_rays``;
    the model needs its ray curves and skew tables.  On the card the march
    is one launch of K4 (``ops/cuda_rays.march_descent``) and the
    relaxation with the times one of K3."""
    spec = descent_spec(model, subgrid_size, max_steps, step_scale, score_k,
                        score_stride, mode)
    mat_flat = _material_flat(model)
    rec_ttf, ttf_index, source_xy, receiver_xy = _ray_inputs(
        model, rec_ttf, ttf_index, source_xy, receiver_xy)
    bx, by, length, reason, _ = cuda_rays.march_descent(
        model, mat_flat, rec_ttf, ttf_index, source_xy, receiver_xy, spec)
    relax_cross = max(max_cross, int(2 * step_scale) + 6)
    bx, by, times = cuda_rays.relax_and_times(
        model, mat_flat, bx, by, length, spec.s, 2 * max(relax_iters, 0),
        relax_cross=relax_cross, quad=relax_quad, times_cross=relax_cross)
    if return_reason:
        return bx, by, length, times, reason
    return bx, by, length, times


def trace_rays_auto(
    model: gridlib.Model,
    rec_ttf,
    ttf_index,
    source_xy,
    receiver_xy,
    subgrid_size: int,
    mode: str = "interp",
    tol: float = 3e-3,
    retrace_chunk: int = 128,
    descent_kw: dict | None = None,
    search_kw: dict | None = None,
):
    """The descent tracer with a certified fallback, driven from the host.
    Every ray is marched by ``trace_rays_descent`` (``descent_kw``); its
    field sampled at its source is the first-arrival time, which no path
    beats, so a ray whose time is not within ``(1 + tol)`` of it (NaN
    included) is retraced by the plane search ``trace_rays``
    (``search_kw``).  All flagged rays go into one ``trace_rays`` call:
    a ray's result does not depend on the rays beside it, so the result
    is the JAX package's at any ``retrace_chunk``, which is accepted and
    ignored (there it is the batch that XLA compiles once).  A retraced
    ray replaces the descent ray when its time is lower or the descent
    time is NaN.  Returns (ray_x, ray_y, lengths, times), padded to the
    wider step buffer, on the model's device.  The certificate is the one
    host read (field indices on the card are copied to the host once,
    before any launch, for the tracers' range checks); on the card the
    trace is one K4, one K2 and two K3 launches, one K4 and one K3 when
    no ray is flagged."""
    descent_kw = dict(descent_kw or {})
    search_kw = dict(search_kw or {})
    s = int(subgrid_size)
    dev = model.device
    tidx_host = torch.as_tensor(ttf_index).cpu()
    rec_ttf, ttf_index, source_xy, receiver_xy = _ray_inputs(
        model, rec_ttf, tidx_host, source_xy, receiver_xy)
    bx, by, lens, times = trace_rays_descent(
        model, rec_ttf, tidx_host, source_xy, receiver_xy, s, mode=mode,
        **descent_kw)
    src = source_xy.to(model.dtype)
    t_true = _sample_ttf(rec_ttf, src[:, 0], src[:, 1], s, mode,
                         ttf_index if rec_ttf.dim() == 3 else None)
    idx = torch.nonzero((~(times <= (1.0 + tol) * t_true)).cpu())[:, 0]
    if not len(idx):
        return bx, by, lens, times

    ridx = idx.to(dev)
    rbx, rby, rlens, rtimes = trace_rays(
        model, rec_ttf, tidx_host[idx], source_xy[ridx], receiver_xy[ridx],
        s, mode=mode, **search_kw)
    W = rbx.shape[1]
    if W > bx.shape[1]:
        bx = torch.nn.functional.pad(bx, (0, W - bx.shape[1]))
        by = torch.nn.functional.pad(by, (0, W - by.shape[1]))
    # both times are integrated exactly, so the lower one is the better
    # Fermat path; a NaN descent time always loses
    d_times = times[ridx]
    take = (rtimes < d_times) | torch.isnan(d_times)
    bx[ridx, :W] = torch.where(take[:, None], rbx, bx[ridx, :W])
    by[ridx, :W] = torch.where(take[:, None], rby, by[ridx, :W])
    lens[ridx] = torch.where(take, rlens, lens[ridx])
    times[ridx] = torch.where(take, rtimes, d_times)
    return bx, by, lens, times


def split_at_cell_boundaries(ray_x, ray_y, max_cross_per_seg: int = 16):
    """Split a ray polyline at every grid-cell boundary it crosses (the
    reference's travel_times utility), as fixed-width arrays.  ``ray_x``,
    ``ray_y``: (P,) vertices in model-grid units.  Returns (xs, ys, valid):
    (P - 1, max_cross_per_seg) points per segment and their mask; the
    valid points in order, after the first vertex, are the reference's
    output."""
    ray_x = torch.as_tensor(ray_x)
    ray_y = torch.as_tensor(ray_y)
    dt = torch.promote_types(ray_x.dtype, torch.float32)
    x1, x2 = ray_x[:-1], ray_x[1:]
    y1, y2 = ray_y[:-1], ray_y[1:]
    dx_zero = x2 == x1
    m = torch.where(dx_zero, 0.0,
                    (y2 - y1) / torch.where(dx_zero, 1.0, x2 - x1))
    c = y1 - m * x1
    dir_x = torch.where(x1 < x2, 1.0, -1.0).to(x1.dtype)
    dir_y = torch.where(y1 < y2, 1.0, -1.0).to(x1.dtype)
    m_safe = torch.where(m == 0, 1.0, m)
    next_x = torch.round(x1) + dir_x * 0.5
    next_y = torch.round(y1) + dir_y * 0.5
    fin_x = torch.zeros_like(dx_zero)
    fin_y = torch.zeros_like(dx_zero)
    xs, ys, valid = [], [], []
    for _ in range(max_cross_per_seg):
        done = fin_x & fin_y
        past_x = ((next_x > x2) & (dir_x == 1)) | ((next_x < x2) & (dir_x == -1))
        next_x = torch.where(past_x & ~fin_x, x2, next_x)
        fin_x = fin_x | past_x
        past_y = ((next_y > y2) & (dir_y == 1)) | ((next_y < y2) & (dir_y == -1))
        next_y = torch.where(past_y & ~fin_y, y2, next_y)
        fin_y = fin_y | past_y
        nxy = m * next_x + c
        nyx = (next_y - c) / m_safe
        dxc = (x1 - next_x) ** 2 + (y1 - nxy) ** 2
        dyc = (x1 - nyx) ** 2 + (y1 - next_y) ** 2
        take_x = ~dx_zero & ((m == 0) | (dxc < dyc))
        xs.append(torch.where(dx_zero, x1, torch.where(take_x, next_x, nyx)))
        ys.append(torch.where(dx_zero, next_y,
                              torch.where(take_x, nxy, next_y)))
        valid.append(~done)
        next_x = torch.where(take_x, next_x + dir_x, next_x)
        next_y = torch.where(~take_x, next_y + dir_y, next_y)
    return (torch.stack(xs, 1).to(dt), torch.stack(ys, 1).to(dt),
            torch.stack(valid, 1))
