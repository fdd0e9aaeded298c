"""Batched Fermat ray tracing through receiver travel-time fields.

Counterpart of ``alifmm_tpu/rays.py`` (main-path subset), in plain
PyTorch: the plane-search march of ``trace_rays(mode="interp")`` with
Simpson candidate scoring, even/odd-wave Fermat relaxation
(``relax_rays``) and exact sorted-crossing time integration
(``ray_times``/``segment_time``).

The march is a Python loop over steps, vectorised over rays and
candidates; it stops when every ray is done or at ``max_steps``.  Each
step costs one host read (the all-done test).  The march loop and the
segment integrator are the next kernels of the port.

Coordinates follow the reference convention: ray (x, y) in fine-grid
units, fields indexed [y, x], materials looked up on the model grid.
"""

from __future__ import annotations

import math

import torch

from . import grid as gridlib
from . import materials as mats

__all__ = ["segment_time", "segment_time_quad", "segment_time_quad3",
           "ray_times", "relax_rays", "trace_rays"]

_BIG = 1.0e30
_RAD2DEG = 180.0 / math.pi


def _full(like, v):
    return torch.full_like(like, v)


def _material_flat(model: gridlib.Model, exact: bool = False):
    """(Z*X, 3) per-cell rows (veln, vel_map, unified-curve index) for the
    segment integrators (the JAX package's fast path)."""
    if exact or model.ray_curve_idx is None:
        raise NotImplementedError("exact per-crossing Christoffel materials")
    Z, X = model.shape
    cols = [model.veln, model.vel_map, model.ray_curve_idx.to(model.dtype)]
    return torch.stack(cols, dim=-1).reshape(Z * X, 3)


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
    cell, and the last breakpoint is always the segment end."""
    Z, X = model.shape
    dt = model.dtype
    s = subgrid_size
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
    return torch.sum(dists / vel, dim=0)


def _simpson_time(model, mat_flat, x1, y1, x2, y2, subgrid_size, fracs,
                  weights):
    """Segment time from slowness samples at ``fracs`` along the segment,
    combined with ``weights``."""
    Z, X = model.shape
    s = subgrid_size
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


def ray_times(model, mat_flat, ray_x, ray_y, lengths, subgrid_size,
              max_cross: int = 16):
    """Travel time along padded ray polylines (R, P): segment i counts when
    i + 1 < lengths."""
    R, P = ray_x.shape
    seg_t = segment_time(model, mat_flat, ray_x[:, :-1], ray_y[:, :-1],
                         ray_x[:, 1:], ray_y[:, 1:], subgrid_size, max_cross)
    idx = torch.arange(P - 1, device=ray_x.device)
    mask = (idx[None, :] + 1) < lengths[:, None]
    return torch.sum(torch.where(mask, seg_t, 0.0), dim=1)


def relax_rays(model, mat_flat, ray_x, ray_y, lengths, subgrid_size,
               iters: int = 2, span: float | None = None,
               max_cross: int = 12, quad: bool | int = False):
    """Parallel Fermat relaxation of ray polylines: each interior vertex
    moves along the perpendicular of its local chord to minimise
    seg(prev, v) + seg(v, next), in odd then even waves (``iters`` times).
    ``quad`` scores with Simpson (3 = 3-point), else the exact integrator."""
    R, P = ray_x.shape
    if P < 3:
        return ray_x, ray_y
    h = float(subgrid_size) if span is None else float(span)
    vidx = torch.arange(1, P - 1, device=ray_x.device)

    def seg(ax, ay, bx, by):
        if quad:
            fn = segment_time_quad3 if quad == 3 else segment_time_quad
            return fn(model, mat_flat, ax, ay, bx, by, subgrid_size)
        return segment_time(model, mat_flat, ax, ay, bx, by, subgrid_size,
                            max_cross)

    xs, ys = ray_x, ray_y
    for parity in [1, 0] * iters:
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
    receiver.  See the JAX package's trace_rays for the knobs.  Not ported
    yet: ``mode="grid"``, the walk scorer ``quad_vel=False``,
    ``fast_step_scale`` and ``exact_materials``."""
    if mode != "interp":
        raise NotImplementedError(f"trace_rays mode={mode!r}")
    if not quad_vel:
        raise NotImplementedError("trace_rays with the walk scorer "
                                  "(quad_vel=False)")
    if fast_step_scale:
        raise NotImplementedError("trace_rays fast_step_scale")
    Z, X = model.shape
    s = int(subgrid_size)
    dt = model.dtype
    dev = model.device
    R = source_xy.shape[0]
    ttf_index = torch.as_tensor(ttf_index, device=dev).to(torch.int64)
    rows, cols = (Z - 1) * s + 1, (X - 1) * s + 1
    k_step = int(step_scale)
    if max_steps is None:
        max_steps = -(-5 * (Z + X) // k_step)
    P = max_steps + 2

    plane_dist = int(plane_dist)
    sd = plane_dist * s + 1
    sd2 = (plane_dist - 1) * s + 1
    stride = float(cand_stride)
    K = int(math.ceil(2 * sd / stride)) + 1

    mat_flat = _material_flat(model, exact_materials)
    sqrt2 = math.sqrt(2.0)
    k_eff = k_step

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
        cx = torch.clamp(x / s, 0.0, TX - 1.0)
        cy = torch.clamp(y / s, 0.0, TZ - 1.0)
        x0 = torch.clamp(torch.floor(cx).to(torch.int64), 0, TX - 2)
        y0 = torch.clamp(torch.floor(cy).to(torch.int64), 0, TZ - 2)
        fx = cx - x0.to(dt)
        fy = cy - y0.to(dt)
        base = off + y0 * TX + x0
        v0, v1 = flat_all[base], flat_all[base + 1]
        v2, v3 = flat_all[base + TX], flat_all[base + TX + 1]
        return (v0 * (1 - fy) * (1 - fx) + v1 * (1 - fy) * fx
                + v2 * fy * (1 - fx) + v3 * fy * fx)

    if quad_vel == 3:
        quad_fn = segment_time_quad3
    else:
        quad_fn = segment_time_quad
    ridx = torch.arange(R, device=dev)
    kcol = torch.arange(K, device=dev)
    kw = stride * torch.arange(K, dtype=dt, device=dev)

    def pick(d, v0, v1, v2, v3):
        d = d.reshape(d.shape + (1,) * (v0.dim() - d.dim()))
        return torch.where(d == 0, v0, torch.where(
            d == 1, v1, torch.where(d == 2, v2, v3)))

    def step(state):
        (last_x, last_y, vec_x, vec_y, bx, by, length, done, reason,
         tt_last_pt) = state
        near2 = (last_x - rec_x) ** 2 + (last_y - rec_y) ** 2
        snap = near2 < (4.0 * s) ** 2
        vec_x = torch.where(snap, rec_x - last_x, vec_x)
        vec_y = torch.where(snap, rec_y - last_y, vec_y)
        off = torch.where(near2 < ((k_step + 3.0) * s) ** 2,
                          _full(near2, float(near_step * s)),
                          _full(near2, float(k_step * s)))

        scores = torch.stack([
            torch.abs(vec_x),
            torch.abs(vec_x + vec_y) / sqrt2,
            torch.abs(vec_y),
            torch.abs(vec_x - vec_y) / sqrt2,
        ])
        dir_index = torch.argmax(scores, dim=0)

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
        n_k = torch.clamp(((hi - lo) / stride).to(torch.int64) + 1, 1, K)

        zw = 0 * w
        px = pick(dir_index, c0[:, None] + zw, w, w, w)
        py = pick(dir_index, w, c1[:, None] - w, c2[:, None] + zw,
                  w + c3[:, None])
        tt_plane = sample_b(px, py)
        seg = quad_fn(model, mat_flat, last_x[:, None], last_y[:, None],
                      px, py, s)
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
        jbest = torch.argmin(val, dim=1)
        v_loc = val[ridx, jbest]
        p_loc = pos[ridx, jbest]
        best_pos = torch.where(v_loc < best_val, p_loc, best_pos)

        wq = lo + torch.minimum(best_pos * stride, hi - lo)
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
                tt_last_pt)

    bx = torch.zeros((R, P), dtype=dt, device=dev)
    by = torch.zeros((R, P), dtype=dt, device=dev)
    bx[:, 0] = src_x
    by[:, 0] = src_y
    arrived0 = (src_x - rec_x) ** 2 + (src_y - rec_y) ** 2 <= (1.6 * s) ** 2
    tt_src = sample_b(torch.round(src_x), torch.round(src_y))
    state = (src_x, src_y, rec_x - src_x, rec_y - src_y, bx, by,
             torch.ones(R, dtype=torch.int64, device=dev), arrived0,
             torch.zeros(R, dtype=torch.int64, device=dev), tt_src)
    k = 0
    while k < max_steps and not bool(state[7].all()):
        state = step(state)
        k += 1
    _, _, _, _, bx, by, length, _, reason, _ = state

    # append the receiver
    bx[ridx, length] = rec_x
    by[ridx, length] = rec_y
    length = length + 1

    final_cross = max(-(-max_cross // 2) + 1, k_eff + 4)
    if relax_iters > 0:
        bx, by = relax_rays(model, mat_flat, bx, by, length, s,
                            iters=relax_iters, max_cross=final_cross,
                            quad=relax_quad)
    times = ray_times(model, mat_flat, bx, by, length, s, final_cross)
    if return_reason:
        return bx, by, length, times, reason
    return bx, by, length, times
