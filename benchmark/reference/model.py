"""The reference's material model, worked out again from the inputs.

Plain numpy and PyTorch, float64, from the maps the benchmark generates
(``veln``, ``velpn``, ``vel_map``, the stiffness row) and the velocity
tables the facade is given.  It imports nothing of the port: the velocity
formulas are frozen copies of the port's host precompute,
``alifmm_tpu_torch/grid.py`` lines 184-225 (the closed-form Christoffel
group and phase velocities) and 237-255 (the FD fallback's slowness
planes), and of ``alifmm_tpu_torch/materials.py`` lines 88-99 (the phase
velocity on the device) and 194-208 (the table interpolation).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["RefModel", "group_velocity_np", "phase_velocity_t",
           "interp_gather"]

_DEG2RAD = np.pi / 180.0


def group_velocity_np(angle_deg, c22, c23, c33, c44, rho, vel_scale=1.0):
    """qP group velocity at ray angle ``angle_deg`` (degrees), stiffness in
    MPa and density in kg/m^3: the closed form, exact on the axes."""
    angle = np.mod(angle_deg, 180.0)
    m90 = np.mod(angle, 90.0)
    near_axis = (m90 < 0.01) | (m90 > 90.0 - 0.01)
    near_90 = np.abs(angle - 90.0) < 1.0
    lam_axis = np.where(near_90, c33, c22)
    v_axis = 1000.0 * vel_scale * np.sqrt(lam_axis / rho)
    ang_safe = np.where(near_axis, 45.0, angle)
    tan_ang = np.tan(np.radians(ang_safe))
    A = c22 + c33 - 2.0 * c44
    B = (c23 + c44) * (tan_ang - 1.0 / tan_ang)
    C = c22 - c33
    disc = np.sqrt(np.maximum(B * B + A * A - C * C, 0.0))
    denom = C - A
    denom = np.where(denom == 0.0, np.finfo(np.float64).tiny, denom)
    sign = np.where(ang_safe < 90.0, -1.0, 1.0)
    phase_ang = np.mod(np.arctan((-B + sign * disc) / denom), np.pi)
    lam = 0.5 * (np.cos(2.0 * phase_ang) * (c22 - c44)
                 + np.sin(2.0 * phase_ang) * (c23 + c44) * tan_ang
                 + c22 + c44)
    v_gen = (1000.0 * vel_scale * np.sqrt(np.maximum(lam, 0.0) / rho)
             / np.cos(np.radians(ang_safe) - phase_ang))
    return np.where(near_axis, v_axis, v_gen)


def phase_velocity_t(angle_deg, c22, c23, c33, c44, rho, vel_scale):
    """qP phase velocity at phase angle ``angle_deg``: the larger
    eigenvalue of the 2 x 2 Christoffel matrix (tensors)."""
    ca = torch.cos(angle_deg * _DEG2RAD)
    sa = torch.sin(angle_deg * _DEG2RAD)
    A = ca * ca * c22 + sa * sa * c44
    B = ca * sa * (c23 + c44)
    C = ca * ca * c44 + sa * sa * c33
    AmC = A - C
    lam = 0.5 * (A + C + torch.sqrt(AmC * AmC + 4.0 * B * B))
    return 1000.0 * vel_scale * torch.sqrt(lam / rho)


def interp_gather(table, eff_deg, col, vel_map):
    """Linear interpolation of a (A, M) velocity table at ``eff_deg`` mod
    180 in column ``col``, times ``vel_map``: samples floor(eff) and
    floor(eff) + 1 mod 180."""
    eff = torch.remainder(eff_deg, 180.0)
    a1 = torch.clamp(torch.floor(eff).to(torch.int64), 0, 179)
    a2 = torch.remainder(a1 + 1, 180)
    w = eff - a1.to(eff.dtype)
    M = table.shape[1]
    flat = table.reshape(-1)
    c = col.to(torch.int64)
    return vel_map * ((1.0 - w) * flat[a1 * M + c] + w * flat[a2 * M + c])


def _np_interp(table, eff, col, vel_map):
    eff = np.mod(eff, 180.0)
    a1 = np.clip(np.floor(eff).astype(np.int64), 0, 179)
    a2 = np.mod(a1 + 1, 180)
    w = eff - a1
    c = np.asarray(col, np.int64)
    return vel_map * ((1.0 - w) * table[a1, c] + w * table[a2, c])


def _nearest(n: int, s: int, device):
    k = torch.arange(s * (n - 1) + 1, device=device)
    return torch.clamp((k + s // 2) // s, 0, n - 1)


class RefModel:
    """Per-cell material planes on a grid (the model grid, or refined
    ``scale`` times by nearest neighbour as the reference's fine path
    refines), float64 on ``device``:

    - ``phase_velocity(eff, velpn, vel_map, stif)``: the ALI update's
      velocity (Christoffel where ``velpn`` is 0, else the phase table's
      column: its value where the column is constant, interpolated where
      it varies);
    - ``fbs``: the FD fallback's group slownesses at its four wave angles;
    - ``group_velocity(cells, eff)``: the ray integrator's group velocity
      on the model grid, from the 1-degree curve of each material (the
      group table's column, or the stiffness row's closed form) by linear
      interpolation.

    ``planes=False`` builds the ray integrator's part only.
    """

    def __init__(self, veln, velpn, vel_map, stif, group_tab, phase_tab,
                 dnx, device, scale: int = 1, planes: bool = True):
        veln = np.asarray(veln, np.float64)
        velpn = np.asarray(velpn, np.int64)
        vel_map = np.asarray(vel_map, np.float64)
        stif = np.asarray(stif, np.float64)
        group_tab = np.asarray(group_tab, np.float64)
        phase_tab = np.asarray(phase_tab, np.float64)
        self.device = torch.device(device)
        self.shape0 = veln.shape  # the model grid's
        self.scale = int(scale)
        self.dnx = float(dnx) / self.scale
        self.has_stif = bool(np.any(stif))
        c = [stif[..., k] for k in range(5)]
        # the FD fallback's slownesses on the model grid
        effs = [] if not planes else [np.mod(0.0 - veln, 180.0),
                np.round(np.mod(45.0 - veln, 180.0)),
                np.mod(-27.0 - veln, 180.0),
                np.mod(27.0 - veln, 180.0)]
        fbs = []
        for eff in effs:
            v = _np_interp(group_tab, eff, velpn, vel_map)
            if self.has_stif:
                v = np.where(velpn != 0, v,
                             group_velocity_np(eff, *c, vel_map))
            fbs.append(1.0 / v)
        # the phase table's constant columns and values
        self._const = {m: float(phase_tab[0, m])
                       for m in range(phase_tab.shape[1])
                       if np.ptp(phase_tab[:181, m]) == 0.0}
        # the ray integrator's curve per material: table columns, then one
        # closed-form curve per stiffness row (per cell: its curve column)
        M = group_tab.shape[1]
        curves = [group_tab[:181]]
        col = velpn.copy()
        if self.has_stif:
            rows, inv = np.unique(stif.reshape(-1, 5), axis=0,
                                  return_inverse=True)
            ang = np.arange(181.0)[:, None]
            curves.append(group_velocity_np(
                ang, *(rows[None, :, k] for k in range(5))))
            col = np.where(velpn != 0, velpn, M + inv.reshape(velpn.shape))
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a),  # noqa: E731
                                      device=self.device)
        self.curves = t(np.concatenate(curves, axis=1))
        self.curve_col = t(col.reshape(-1))
        self.veln0 = t(veln.reshape(-1))
        self.vel_map0 = t(vel_map.reshape(-1))
        self.phase_tab = t(phase_tab)
        if not planes:
            return
        planes = [veln, velpn.astype(np.float64), vel_map] + c + fbs
        P = t(np.stack(planes))
        if self.scale > 1:
            iz = _nearest(P.shape[1], self.scale, self.device)
            ix = _nearest(P.shape[2], self.scale, self.device)
            P = P[:, iz][:, :, ix]
        self.veln, self.vel_map = P[0], P[2]
        self.velpn = P[1].to(torch.int64)
        self.stif = P[3:8].permute(1, 2, 0)
        self.fbs = P[8:12]

    def phase_velocity(self, eff, velpn, vel_map, stif):
        eff = torch.remainder(eff, 180.0)
        v = interp_gather(self.phase_tab, eff,
                          torch.clamp(velpn, 0, self.phase_tab.shape[1] - 1),
                          vel_map)
        for m, c in self._const.items():
            v = torch.where(velpn == m, vel_map * c, v)
        if self.has_stif:
            v_chr = phase_velocity_t(eff, *(stif[..., k] for k in range(5)),
                                     vel_map)
            v = torch.where(velpn == 0, v_chr, v)
        return v

    def group_velocity(self, cells, eff):
        """Group velocity of model-grid cells (flat indices) at effective
        angles ``eff`` (degrees)."""
        return interp_gather(self.curves, eff, self.curve_col[cells],
                             self.vel_map0[cells])
