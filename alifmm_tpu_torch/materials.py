"""L0 material physics in PyTorch: Christoffel velocities, table lookups
and the wave-mode table builders.

Counterpart of ``alifmm_tpu/materials.py``.  All angle arithmetic is in
degrees and every formula keeps the JAX package's operation order, so
float64 results agree to the last few ulps.  The host-side table builders
(``generate_*``, ``first_arrival_group_curve``,
``wavefront_corner_angles``) are numpy and scipy, as in the JAX package.

``interp_table`` is the gather form of the table lookup.  The JAX package
expands it into hat functions because gathers are slow on a TPU; the
expansion and the gather give the same two products and the same sum.
"""

from __future__ import annotations

import math
from functools import lru_cache as _lru_cache

import numpy as np
import torch

from .ops._math import sqrt

__all__ = [
    "group_velocity_christoffel",
    "phase_velocity_christoffel",
    "generate_group_vel_curve",
    "generate_phase_vel_curve",
    "generate_mode_curves",
    "first_arrival_group_curve",
    "wavefront_corner_angles",
    "angular_distance_deg",
    "slowness_derivative",
    "default_tables",
    "build_tables",
    "interp_table",
    "interp_table_gather",
    "column_info",
]

_DEG2RAD = math.pi / 180.0


def _deg2rad(x):
    """Degrees to radians (numpy, as the JAX package's helper)."""
    return x * (np.pi / 180.0)


def group_velocity_christoffel(angle_deg, c22, c23, c33, c44, rho,
                               vel_scale=1.0):
    """qP group velocity at group angle ``angle_deg`` (degrees), with the
    reference's near-axis special cases (stiffness in MPa)."""
    angle = torch.remainder(angle_deg, 180.0)
    m90 = torch.remainder(angle, 90.0)
    near_axis = (m90 < 0.01) | (m90 > 90.0 - 0.01)
    near_90 = torch.abs(angle - 90.0) < 1.0
    lam_axis = torch.where(near_90, c33, c22)
    v_axis = 1000.0 * vel_scale * sqrt(lam_axis / rho)

    # angle replaced by 45 deg where the axis branch is taken, so tan()
    # stays finite and no NaN leaks through the select
    ang_safe = torch.where(near_axis, 45.0, angle)
    tan_ang = torch.tan(ang_safe * _DEG2RAD)
    A = c22 + c33 - 2.0 * c44
    B = (c23 + c44) * (tan_ang - 1.0 / tan_ang)
    C = c22 - c33
    disc = sqrt(torch.clamp_min(B * B + A * A - C * C, 0.0))
    denom = C - A
    denom = torch.where(denom == 0.0, torch.finfo(angle.dtype).tiny, denom)
    sign = torch.where(ang_safe < 90.0, -1.0, 1.0).to(angle.dtype)
    phase_ang = torch.remainder(torch.atan((-B + sign * disc) / denom), math.pi)
    lam = 0.5 * (
        torch.cos(2.0 * phase_ang) * (c22 - c44)
        + torch.sin(2.0 * phase_ang) * (c23 + c44) * tan_ang
        + c22
        + c44
    )
    v_gen = (
        1000.0
        * vel_scale
        * sqrt(torch.clamp_min(lam, 0.0) / rho)
        / torch.cos(ang_safe * _DEG2RAD - phase_ang)
    )
    return torch.where(near_axis, v_axis, v_gen)


def phase_velocity_christoffel(angle_deg, c22, c23, c33, c44, rho,
                               vel_scale=1.0):
    """qP phase velocity at phase angle ``angle_deg`` (degrees): the larger
    eigenvalue of the 2x2 Christoffel matrix."""
    ca = torch.cos(angle_deg * _DEG2RAD)
    sa = torch.sin(angle_deg * _DEG2RAD)
    A = ca * ca * c22 + sa * sa * c44
    B = ca * sa * (c23 + c44)
    C = ca * ca * c44 + sa * sa * c33
    AmC = A - C
    lam = 0.5 * (A + C + sqrt(AmC * AmC + 4.0 * B * B))
    return 1000.0 * vel_scale * sqrt(lam / rho)


def generate_group_vel_curve(c22, c23, c33, c44, density):
    """361-entry group-velocity curve of one material (1-degree steps,
    180-degree periodic) from stiffness in Pa and density: host numpy in
    float64, integer angles, exact axis values at multiples of 90."""
    out = np.zeros(361)
    for angle in range(181):
        if angle % 90 == 0:
            lam = c33 if angle % 180 == 90 else c22
            v = np.sqrt(lam / density)
        else:
            tan_ang = np.tan(np.radians(angle))
            A = c22 + c33 - 2 * c44
            B = (c23 + c44) * (tan_ang - 1.0 / tan_ang)
            C = c22 - c33
            root = np.sqrt(B**2 + A**2 - C**2)
            if angle < 90:
                pa = np.arctan((-B - root) / (C - A)) % np.pi
            else:
                pa = np.arctan((-B + root) / (C - A)) % np.pi
            lam = 0.5 * (
                np.cos(2 * pa) * (c22 - c44)
                + np.sin(2 * pa) * (c23 + c44) * tan_ang
                + c22
                + c44
            )
            v = np.sqrt(lam / density) / np.cos(np.radians(angle) - pa)
        out[angle] = v
    out[180:] = out[:181]
    return out


def generate_phase_vel_curve(c22, c23, c33, c44, density):
    """361-entry phase-velocity curve of one material (see
    ``generate_group_vel_curve``)."""
    out = np.zeros(361)
    for angle in range(181):
        if angle % 90 == 0:
            lam = c33 if angle % 180 == 90 else c22
            v = np.sqrt(lam / density)
        else:
            ca = np.cos(np.radians(angle))
            sa = np.sin(np.radians(angle))
            A = ca * ca * c22 + sa * sa * c44
            B = ca * sa * (c23 + c44)
            C = ca * ca * c44 + sa * sa * c33
            v = np.sqrt((A + C + np.sqrt((A - C) ** 2 + 4 * B * B))
                        / (2 * density))
        out[angle] = v
    out[180:] = out[:181]
    return out


def default_tables():
    """Default velocity tables: column 0 is the angle, column 1 an
    isotropic unit-velocity material."""
    tab = np.ones((361, 2))
    tab[:, 0] = np.arange(0, 361)
    return tab, tab.copy()


def build_tables(materials, velocity_dat=None, phase_vel=None,
                 keep_materials=False):
    """(group, phase) velocity tables from material rows (c22, c23, c33,
    c44, density) in Pa.  ``keep_materials`` appends the new columns to the
    given tables; otherwise the tables are rebuilt with column 0 the angle
    (a 2-D ``materials`` sizes them by its column count, as the reference
    does).  Returns (group_tab, phase_tab, new column ids)."""
    materials = np.asarray(materials)
    rows = materials[None, :] if materials.ndim == 1 else materials
    if keep_materials:
        if velocity_dat is None or phase_vel is None:
            raise ValueError("keep_materials needs the tables to extend")
        base = velocity_dat.shape[1]
        n_fill = rows.shape[0]
        g = np.zeros((361, base + n_fill))
        p = np.zeros((361, base + n_fill))
        g[:, :base] = velocity_dat
        p[:, :base] = phase_vel
    else:
        base = 1
        ncols = 2 if materials.ndim == 1 else materials.shape[1] + 1
        n_fill = min(rows.shape[0], ncols - 1)
        g = np.zeros((361, ncols))
        p = np.zeros((361, ncols))
        g[:, 0] = np.arange(0, 361)
        p[:, 0] = np.arange(0, 361)
    for i in range(n_fill):
        g[:, base + i] = generate_group_vel_curve(*rows[i])
        p[:, base + i] = generate_phase_vel_curve(*rows[i])
    return g, p, list(range(base, base + n_fill))


def interp_table_gather(table, eff_angle_deg, mat_idx, vel_map):
    """Linear interpolation of a (A, M) velocity table at ``eff_angle_deg``
    for per-point material ``mat_idx``:
    ``v = vel_map * ((1-w) T[a1, m] + w T[a2, m])`` with ``a1 = floor(eff)``
    and ``a2 = (a1 + 1) % 180``."""
    eff = torch.remainder(eff_angle_deg, 180.0)
    a1 = torch.clamp(torch.floor(eff).to(torch.int64), 0, 179)
    a2 = torch.remainder(a1 + 1, 180)
    w = eff - a1.to(eff.dtype)
    M = table.shape[1]
    flat = table.reshape(-1)
    m = mat_idx.to(torch.int64)
    v1 = flat[a1 * M + m]
    v2 = flat[a2 * M + m]
    return vel_map * ((1.0 - w) * v1 + w * v2)


def column_info(table, used=None):
    """Static per-column summary ``((m, const_or_None), ...)`` of the used
    columns of a host table (see the JAX package's ``column_info``)."""
    t = np.asarray(table)
    M = t.shape[1]
    cols = range(M) if used is None else sorted(int(u) for u in used)
    out = []
    for m in cols:
        if m < 0 or m >= M:
            continue
        col = t[:181, m]
        out.append((m, float(col[0]) if np.ptp(col) == 0.0 else None))
    return tuple(out)


def column_modes(info, M):
    """Per-column dispatch of ``interp_table`` as two host arrays: mode 0
    (column not in ``info``: the lookup yields 1), 1 (constant column:
    its value), 2 (interpolate).  ``info=None`` interpolates every
    column."""
    mode = np.full(M, 2 if info is None else 0, np.int32)
    const = np.zeros(M, np.float64)
    for (m, c) in info or ():
        mode[m] = 2 if c is None else 1
        const[m] = 0.0 if c is None else c
    return mode, const


def interp_table(table, eff_angle_deg, mat_idx, vel_map, info=None):
    """Table lookup with the JAX package's ``info`` semantics: constant
    columns return their value exactly, columns outside ``info`` return 1,
    the others interpolate (``interp_table_gather``)."""
    if info is None:
        return interp_table_gather(table, eff_angle_deg, mat_idx, vel_map)
    eff = torch.remainder(eff_angle_deg, 180.0)
    mat_idx = mat_idx.to(torch.int64)
    shape = torch.broadcast_shapes(eff.shape, mat_idx.shape)
    out = torch.ones(shape, dtype=eff.dtype, device=eff.device)
    varying = [m for (m, c) in info if c is None]
    if varying:
        m_safe = torch.clamp(mat_idx, 0, table.shape[1] - 1)
        gathered = interp_table_gather(table, eff, m_safe, 1.0)
    for (m, c) in info:
        val = gathered if c is None else torch.full_like(out, c)
        out = torch.where(mat_idx == m, val, out)
    return vel_map * out


def slowness_derivative(angle_deg, c22, c23, c33, c44, rho, vel_scale=1.0,
                        eps=0.01):
    """d(slowness)/d(angle) of the qP group-velocity curve by the
    reference's one-sided finite difference (slown_d_slown_stif,
    Anis_TTF_rays.py:3468-3518): zero within 0.01 degrees of a symmetry
    axis, stepping ``eps`` degrees towards the nearer axis elsewhere.
    Stiffness in MPa; the stiffness arguments broadcast against the
    angles and take their dtype."""
    if not isinstance(angle_deg, torch.Tensor):
        angle_deg = torch.as_tensor(np.asarray(angle_deg, np.float64))
    a = torch.remainder(angle_deg, 180.0)
    c22, c23, c33, c44, rho = (
        torch.as_tensor(c, dtype=a.dtype, device=a.device)
        for c in (c22, c23, c33, c44, rho))
    m90 = torch.remainder(a, 90.0)
    on_axis = (m90 < 0.01) | (m90 > 90.0 - 0.01)
    step = torch.where(m90 < 45.0, torch.full_like(a, eps),
                       torch.full_like(a, -eps))
    s1 = 1.0 / group_velocity_christoffel(a, c22, c23, c33, c44, rho,
                                          vel_scale)
    s2 = 1.0 / group_velocity_christoffel(a + step, c22, c23, c33, c44, rho,
                                          vel_scale)
    return torch.where(on_axis, torch.zeros_like(a), (s1 - s2) / step)


def _phase_velocity_mode(angle_rad, c22, c23, c33, c44, c66, rho, mode):
    """Phase velocity (m/s) of one bulk mode in the 2-3 plane of an
    orthotropic medium, stiffness in Pa: qP and qSV from the larger and
    the smaller eigenvalue of the 2x2 in-plane Christoffel matrix, qSH
    from the decoupled c66/c44 row."""
    ca = np.cos(angle_rad)
    sa = np.sin(angle_rad)
    if mode == "qSH":
        lam = ca * ca * c66 + sa * sa * c44
        return np.sqrt(lam / rho)
    A = ca * ca * c22 + sa * sa * c44
    B = ca * sa * (c23 + c44)
    C = ca * ca * c44 + sa * sa * c33
    disc = np.sqrt((A - C) ** 2 + 4.0 * B * B)
    lam = 0.5 * (A + C + disc) if mode == "qP" else 0.5 * (A + C - disc)
    return np.sqrt(lam / rho)


def _support_of_points(px, py, out_angles):
    """Support function ``h(theta) = max_i (px_i cos theta + py_i sin
    theta)`` of a 2-D point set at ``out_angles`` (radians), through the
    convex hull: the supporting vertex for direction theta is the one whose
    adjacent edges' outward normals bracket theta, found by a searchsorted
    over the edge-normal angles."""
    from scipy.spatial import ConvexHull

    pts = np.column_stack([np.asarray(px, float), np.asarray(py, float)])
    hull = ConvexHull(pts)
    v = pts[hull.vertices]               # counter-clockwise in 2-D
    d = np.roll(v, -1, axis=0) - v       # edge j: v[j] -> v[j+1]
    psi = np.arctan2(-d[:, 0], d[:, 1])  # outward normal angle of edge j
    # vertex v[j] supports theta in [psi[j-1], psi[j]] (mod 2 pi)
    t = np.mod(psi - psi[0], 2.0 * np.pi)
    th = np.asarray(out_angles, float)
    q = np.mod(th - psi[0], 2.0 * np.pi)
    idx = np.searchsorted(t, q, side="left") % len(v)
    return v[idx, 0] * np.cos(th) + v[idx, 1] * np.sin(th)


def first_arrival_group_curve(c22, c23, c33, c44, rho, c66=None, mode="qSV",
                              n_fine=14400):
    """361-entry first-arrival group-speed curve of one bulk mode (stiffness
    in Pa): the convex hull of the wave surface, from the plane-wave
    envelope ``v_hull(theta) = min over |phi - theta| < 90 deg of
    v_phase(phi) / cos(theta - phi)``.  Where the group curve is convex
    this is the classical group speed; across the concave (triplication)
    sectors of qSV the hull bridges the lobes and gives the faster
    multi-segment first arrival.  Built from the phase curve alone, so it
    is the polar dual of the phase table of ``generate_mode_curves``.
    Memoised; returns a copy."""
    if c66 is None:
        c66 = c44
    return _group_curve_cached(
        float(c22), float(c23), float(c33), float(c44), float(rho),
        float(c66), str(mode), int(n_fine),
    ).copy()


@_lru_cache(maxsize=64)
def _group_curve_cached(c22, c23, c33, c44, rho, c66, mode, n_fine):
    phi = np.linspace(0.0, 2.0 * np.pi, 2 * n_fine, endpoint=False)
    vp = _phase_velocity_mode(phi, c22, c23, c33, c44, c66, rho, mode)
    return _radial_from_support(phi, vp, np.radians(np.arange(361.0)))


def _radial_from_support(phi, h, out_angles):
    """Radial function of the convex body whose support function is ``h``
    (the intersection of the half-planes x . n_phi <= h(phi)), by polar
    duality: ``r(theta) = 1 / h_dual(theta)``, with the dual the convex
    hull of the points n_phi / h(phi)."""
    phi = np.asarray(phi, float)
    h = np.asarray(h, float)
    return 1.0 / _support_of_points(
        np.cos(phi) / h, np.sin(phi) / h, out_angles
    )


def _support_from_radial(phi, r, out_angles):
    """Support function ``h(theta) = max over phi of r(phi) cos(phi -
    theta)`` of a radial point set, that is of its convex hull: with
    ``_radial_from_support`` a round trip that convexifies a non-convex
    curve and leaves a convex one unchanged."""
    phi = np.asarray(phi, float)
    r = np.asarray(r, float)
    return _support_of_points(r * np.cos(phi), r * np.sin(phi), out_angles)


def wavefront_corner_angles(c22, c23, c33, c44, rho, c66=None, mode="qSV",
                            n_fine=14400, min_span_deg=0.5):
    """Ray-direction angles (degrees, [0, 360)) at which the first-arrival
    wavefront of a homogeneous medium has corners: the outward normals of
    the slowness hull's edges that bridge a concave dimple (an edge that
    skips more than ``min_span_deg`` of consecutive phase samples).  A
    convex mode (qP) has none and returns an empty array."""
    from scipy.spatial import ConvexHull

    if c66 is None:
        c66 = c44
    phi = np.linspace(0.0, 2.0 * np.pi, 2 * n_fine, endpoint=False)
    vp = _phase_velocity_mode(phi, c22, c23, c33, c44, c66, rho, str(mode))
    pts = np.column_stack([np.cos(phi) / vp, np.sin(phi) / vp])
    hull = ConvexHull(pts)
    vidx = hull.vertices                      # counter-clockwise indices
    n = len(phi)
    nxt = np.roll(vidx, -1)
    skip = np.mod(nxt - vidx, n)              # samples skipped by each edge
    span_deg = skip * (360.0 / n)
    bridge = span_deg > max(min_span_deg, 2.5 * 360.0 / n)
    if not bridge.any():
        return np.zeros((0,))
    v = pts[vidx]
    d = pts[nxt] - v
    psi = np.degrees(np.arctan2(-d[:, 0], d[:, 1]))  # outward edge normal
    return np.sort(np.mod(psi[bridge], 360.0))


def angular_distance_deg(a, b):
    """Smallest absolute angular distance |a - b| on the circle, in
    degrees (numpy)."""
    d = np.mod(np.asarray(a) - np.asarray(b), 360.0)
    return np.minimum(d, 360.0 - d)


def generate_mode_curves(c22, c23, c33, c44, rho, c66=None, mode="qP",
                         n_fine=14400):
    """(group_curve, phase_curve), 361 entries each, of one bulk mode
    (stiffness in Pa): ``qP``, ``qSV`` (the smaller in-plane Christoffel
    eigenvalue) or ``qSH`` (c66/c44; ``c66`` defaults to c44).  The group
    curve is ``first_arrival_group_curve``; the phase curve is the
    convexified slowness (radial -> support -> radial), which equals the
    Christoffel phase curve on convex modes and removes the qSV dimples'
    faster-than-first-arrival plane waves.  Both describe one convex
    wavefront and go into velocity tables as ``build_tables``' columns
    do.  Memoised; returns copies."""
    if c66 is None:
        c66 = c44
    g, p = _mode_curves_cached(
        float(c22), float(c23), float(c33), float(c44), float(rho),
        float(c66), str(mode), int(n_fine),
    )
    return g.copy(), p.copy()


@_lru_cache(maxsize=64)
def _mode_curves_cached(c22, c23, c33, c44, rho, c66, mode, n_fine):
    group = first_arrival_group_curve(c22, c23, c33, c44, rho, c66, mode,
                                      n_fine)
    phi = np.linspace(0.0, 2.0 * np.pi, 2 * n_fine, endpoint=False)
    vp = _phase_velocity_mode(phi, c22, c23, c33, c44, c66, rho, mode)
    h_slw = _support_from_radial(phi, 1.0 / vp, phi)
    r_hull_slw = _radial_from_support(phi, h_slw,
                                      np.radians(np.arange(361.0)))
    phase = 1.0 / r_hull_slw
    return group, phase
