"""L0 material physics in PyTorch: Christoffel velocities and table lookups.

Counterpart of ``alifmm_tpu/materials.py`` (main-path subset).  All angle
arithmetic is in degrees and every formula keeps the JAX package's
operation order, so float64 results agree to the last few ulps.

``interp_table`` is the gather form of the table lookup.  The JAX package
expands it into hat functions because gathers are slow on a TPU; the
expansion and the gather give the same two products and the same sum.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "group_velocity_christoffel",
    "phase_velocity_christoffel",
    "generate_group_vel_curve",
    "generate_phase_vel_curve",
    "default_tables",
    "build_tables",
    "interp_table",
    "interp_table_gather",
    "column_info",
]

_DEG2RAD = math.pi / 180.0


def group_velocity_christoffel(angle_deg, c22, c23, c33, c44, rho,
                               vel_scale=1.0):
    """qP group velocity at group angle ``angle_deg`` (degrees), with the
    reference's near-axis special cases (stiffness in MPa)."""
    angle = torch.remainder(angle_deg, 180.0)
    m90 = torch.remainder(angle, 90.0)
    near_axis = (m90 < 0.01) | (m90 > 90.0 - 0.01)
    near_90 = torch.abs(angle - 90.0) < 1.0
    lam_axis = torch.where(near_90, c33, c22)
    v_axis = 1000.0 * vel_scale * torch.sqrt(lam_axis / rho)

    # angle replaced by 45 deg where the axis branch is taken, so tan()
    # stays finite and no NaN leaks through the select
    ang_safe = torch.where(near_axis, 45.0, angle)
    tan_ang = torch.tan(ang_safe * _DEG2RAD)
    A = c22 + c33 - 2.0 * c44
    B = (c23 + c44) * (tan_ang - 1.0 / tan_ang)
    C = c22 - c33
    disc = torch.sqrt(torch.clamp_min(B * B + A * A - C * C, 0.0))
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
        * torch.sqrt(torch.clamp_min(lam, 0.0) / rho)
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
    lam = 0.5 * (A + C + torch.sqrt(AmC * AmC + 4.0 * B * B))
    return 1000.0 * vel_scale * torch.sqrt(lam / rho)


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
