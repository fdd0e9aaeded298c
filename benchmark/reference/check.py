"""The comparison that decides ``correct``: the numbers the reference
reads from what the timed calls returned.

Every function takes the program's outputs only to judge them, with the
reference's own model (``reference/model.py``) and its own operator
(``reference/stencils.py``), in float64:

- ``field_numbers``: the points of the returned fields that are unknown,
  not finite or not positive away from their element, or not 0 at it;
  and per sampled element the sweep operator's residual on its field: one
  whole-grid application of the local update with the sweeps' causal rule
  and the polish's replace accumulation (``alifmm_tpu_torch/ops/sweep.py``
  ``_line``, lines 120-150), relative to the field, at every point outside
  the near-source window that the refined patches fix, as its median and
  90th percentile.  A converged first-arrival field is its own update; a
  field of another model, a lower precision or an unfinished solve is
  not;
- ``ray_numbers``: each returned ray time against the time the reference
  integrates along the returned path through its own model, and the
  path's ends against the elements.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import stencils
from .model import RefModel

__all__ = ["field_numbers", "ray_numbers", "source_points", "INF"]

INF = stencils.INF
# rows of a field the residual handles at once (float64 temporaries of the
# local update: a few hundred MB at the fine width)
ROW_BLOCK = 512


def source_points(sx, sy, dnx: float, scale: int):
    """(row, col) of each element on the field grid refined ``scale``
    times."""
    isx = np.round(np.asarray(sx) / dnx).astype(np.int64)
    isz = np.round(np.asarray(sy) / dnx).astype(np.int64)
    return isz * scale, isx * scale


def _window(c: int, half: int, n: int):
    h = min(half, (n - 1) // 2)
    o = min(max(c - h, 0), max(n - 1 - 2 * h, 0))
    return o, o + 2 * h


def _offsets_masks(Z, X, r0, r1, device):
    iz = torch.arange(r0, r1, device=device)[:, None]
    ix = torch.arange(X, device=device)[None, :]
    inb = {}
    for (dz, dx) in stencils.OFFSETS:
        ok = ((iz + dz >= 0) & (iz + dz <= Z - 1)
              & (ix + dx >= 0) & (ix + dx <= X - 1))
        inb[(dz, dx)] = ok.expand(r1 - r0, X)
    edges = dict(top=(iz == 0).expand(r1 - r0, X),
                 bottom=(iz == Z - 1).expand(r1 - r0, X),
                 left=(ix == 0).expand(r1 - r0, X),
                 right=(ix == X - 1).expand(r1 - r0, X))
    return inb, edges


def sweep_update(ref: RefModel, T):
    """One whole-grid application of the sweeps' local update to a field
    (Z, X), float64: a neighbour counts where it is known and earlier than
    the point (the causal rule), and the new value replaces the old one
    where it is known (the polish's accumulation)."""
    Z, X = T.shape
    Tp = torch.nn.functional.pad(T[None], (2, 2, 2, 2), value=INF)[0]
    out = torch.empty_like(T)
    for r0 in range(0, Z, ROW_BLOCK):
        r1 = min(Z, r0 + ROW_BLOCK)
        center = T[r0:r1]
        nbr, known = {}, {}
        for (dz, dx) in stencils.OFFSETS:
            v = Tp[2 + dz + r0: 2 + dz + r1, 2 + dx: 2 + dx + X]
            nbr[(dz, dx)] = v
            known[(dz, dx)] = (v < INF * 0.5) & (v < center)
        inb, edges = _offsets_masks(Z, X, r0, r1, T.device)
        fbs = [ref.fbs[f, r0:r1] for f in range(4)]
        new = stencils.local_update(
            nbr, known, inb, center, ref.veln[r0:r1], ref.velpn[r0:r1],
            ref.vel_map[r0:r1], ref.stif[r0:r1], fbs, edges,
            ref.phase_velocity, ref.dnx, causal=True)
        out[r0:r1] = torch.where(new < INF * 0.5, new, center)
    return out


def field_numbers(ref: RefModel, fields, rows, cols, sample, half: int):
    """(bad points over all fields, worst median residual, worst 90th
    percentile residual) of ``fields`` (n, Z, X) on ``ref``'s grid,
    elements at (rows, cols); the residual over the elements ``sample``,
    outside each one's window of half width ``half`` (the final stage's
    fixed points lie inside it)."""
    n, Z, X = fields.shape
    bad = 0
    for k in range(n):
        f = fields[k]
        r, c = int(rows[k]), int(cols[k])
        wrong = ~torch.isfinite(f) | (f >= INF * 0.5) | (f <= 0)
        wrong[r, c] = ~(f[r, c] == 0)
        bad += int(wrong.sum())
    p50, p90 = 0.0, 0.0
    for k in sample:
        T = fields[k].to(device=ref.device, dtype=torch.float64)
        new = sweep_update(ref, T)
        keep = torch.isfinite(T) & (T > 0) & (T < INF * 0.5)
        z0, z1 = _window(int(rows[k]), half, Z)
        x0, x1 = _window(int(cols[k]), half, X)
        keep[z0:z1 + 1, x0:x1 + 1] = False
        r = ((new - T).abs() / T)[keep]
        if r.numel() == 0:
            continue
        r = torch.where(torch.isfinite(r), r, torch.full_like(r, math.inf))
        r = r.sort().values
        m = r.numel() - 1
        p50 = max(p50, float(r[m // 2]))
        p90 = max(p90, float(r[(9 * m) // 10]))
    return bad, p50, p90


def path_time(ref: RefModel, px, py, lens, max_cross: int):
    """Travel time (R,) along polylines (R, P) in model-grid coordinates
    (x the column, y the row) through ``ref``'s model grid: each segment
    cut at the first ``max_cross`` cell boundaries it crosses on each axis
    (cells centred on the nodes) and at its end, each piece at the group
    velocity of the cell at its midpoint at the segment's angle relative
    to the cell's orientation; segment i counts where i + 1 < lens.  This
    is the ray time as the configuration defines it
    (``alifmm_tpu_torch/rays.py`` ``segment_time``, lines 196-243: its
    sorted crossings, at most ``max_cross`` an axis)."""
    dev, dt = ref.device, torch.float64
    px = torch.as_tensor(px, device=dev, dtype=dt)
    py = torch.as_tensor(py, device=dev, dtype=dt)
    lens = torch.as_tensor(lens, device=dev)
    Z, X = ref.shape0
    x1, y1, x2, y2 = px[:, :-1], py[:, :-1], px[:, 1:], py[:, 1:]
    dx, dy = x2 - x1, y2 - y1
    k = torch.arange(max_cross, device=dev, dtype=dt)[:, None, None]

    def cuts(p1, d):
        zero = d == 0
        sgn = torch.where(d < 0, -1.0, 1.0).to(dt)
        t = (torch.round(p1) + sgn * (k + 0.5) - p1) / torch.where(zero, 1.0,
                                                                   d)
        return torch.where(zero, 1.0, t.clamp(0.0, 1.0))

    one = torch.ones_like(dx)[None]
    t = torch.sort(torch.cat([cuts(x1, dx), cuts(y1, dy), one]), 0).values
    t0 = torch.cat([torch.zeros_like(one), t[:-1]])
    tm = 0.5 * (t0 + t)
    cx = torch.round(x1 + tm * dx).clamp(0, X - 1).to(torch.int64)
    cy = torch.round(y1 + tm * dy).clamp(0, Z - 1).to(torch.int64)
    cells = cy * X + cx
    angle = torch.where(dx == 0, torch.zeros_like(dx),
                        torch.atan(dy / torch.where(dx == 0, 1.0, dx))
                        * (180.0 / math.pi))
    eff = torch.remainder(ref.veln0[cells] - angle[None], 180.0)
    v = ref.group_velocity(cells, eff)
    seg = (ref.dnx * ref.scale * torch.sqrt(dx * dx + dy * dy)[None]
           * (t - t0) / v).sum(0)
    idx = torch.arange(px.shape[1] - 1, device=dev)
    return torch.where(idx[None] + 1 < lens[:, None], seg,
                       torch.zeros_like(seg)).sum(1)


def ray_numbers(ref: RefModel, times, px, py, lens, src_xy, rec_xy,
                max_cross: int):
    """(widest relative gap of the returned ray times from the reference's
    times along the returned paths, farthest path end from its element in
    cells) of R rays: ``times`` (R,), ``px``/``py`` (R, P), ``lens`` (R,),
    element points (R, 2) as (x, y) in model cells; ``max_cross``: the
    configuration's crossings a segment integrates per axis."""
    t_ref = path_time(ref, px, py, lens, max_cross)
    t = torch.as_tensor(np.asarray(times), device=ref.device,
                        dtype=torch.float64)
    g = (t - t_ref).abs() / t_ref
    g = torch.where(torch.isfinite(g), g, torch.full_like(g, math.inf))
    lens = np.asarray(lens, np.int64)
    px, py = np.asarray(px), np.asarray(py)
    R = np.arange(len(lens))
    last = np.clip(lens - 1, 0, None)
    head = np.stack([px[R, 0], py[R, 0]], 1)
    tail = np.stack([px[R, last], py[R, last]], 1)
    off = np.maximum(np.hypot(*(head - src_xy).T),
                     np.hypot(*(tail - rec_xy).T))
    off = np.where(lens >= 2, off, np.inf)
    return float(g.max()), float(off.max())
