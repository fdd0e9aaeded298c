"""Seeded weld maps and the inspection array.

Frozen copy of the port's generator, ``alifmm_tpu_torch/weld_data.py``:
``weld_maps`` follows ``weld_model_arrays`` (lines 47-81) and
``transducers`` follows ``transducers`` (lines 84-104).  Two departures,
both of data and not of arithmetic: the stiffness row (c22, c23, c33,
c44 in MPa, density in kg/m^3) comes from the configuration file instead of
``bench_data/weld_stif_den.npy``, and the 3 x 3 table of domain angles is
returned beside the maps, so that the traffic's chain can turn one domain
and rebuild ``veln``.  Every number here is numpy on the host; the same seed
gives the same maps.
"""

from __future__ import annotations

import numpy as np

__all__ = ["weld_maps", "veln_of", "transducers", "Weld"]


class Weld:
    """One weld's maps: ``veln`` (float64 degrees), ``velpn`` (int64 table
    column, 0 = Christoffel on the stiffness row), ``vel_map`` (float64),
    ``stif`` ((Z, X, 5) int64, MPa and kg/m^3), the weld mask, the domain
    of every cell (depth band x 3 + lateral band) and the domain angles."""

    def __init__(self, veln, velpn, vel_map, stif, weld, domain, angles):
        self.veln, self.velpn, self.vel_map, self.stif = (veln, velpn,
                                                          vel_map, stif)
        self.weld, self.domain, self.angles = weld, domain, angles

    def turned(self, angles):
        """The same weld with new domain angles (3, 3)."""
        return Weld(veln_of(self.weld, self.domain, angles), self.velpn,
                    self.vel_map, self.stif, self.weld, self.domain, angles)


def veln_of(weld, domain, angles):
    """The orientation map of domain angles (3, 3): the domain's angle in
    the weld, 0 in the parent metal (``weld_model_arrays`` line 78)."""
    return np.where(weld, angles.reshape(-1)[domain], 0).astype(np.float64)


def weld_maps(seed: int, cfg: dict) -> Weld:
    """The procedural weld of ``cfg`` from ``seed``: a V-shaped trapezoid
    about the centre column, 9 orientation domains (3 depth bands x 3
    lateral bands), grains tilted towards the centre line per depth band
    with a jitter per domain, mirrored left and right."""
    w = cfg["weld"]
    rng = np.random.default_rng(seed)
    Z, X = cfg["shape"]
    zz, xx = np.meshgrid(np.arange(Z), np.arange(X), indexing="ij")
    depth = zz / max(Z - 1, 1)
    top, bot = w["top_frac"], w["bot_frac"]
    half = 0.5 * X * (top + (bot - top) * depth)
    xc = 0.5 * (X - 1)
    u = (xx - xc) / half
    weld = np.abs(u) <= 1.0

    band = np.minimum((depth * 3).astype(int), 2)
    lat = np.where(u < -1.0 / 3.0, 0, np.where(u > 1.0 / 3.0, 2, 1))
    lo, hi = w["tilt_deg"]
    tilt = rng.integers(lo, hi, size=3)
    j = w["jitter_deg"]
    jitter = rng.integers(-j, j + 1, size=(3, 3))
    ang = np.empty((3, 3), np.int64)
    ang[:, 0] = 90 - tilt
    ang[:, 1] = 90
    ang[:, 2] = 90 + tilt
    ang = np.mod(ang + jitter, 180)
    domain = band * 3 + lat
    p = cfg["parent"]
    velpn = np.where(weld, 0, p["velpn"]).astype(np.int64)
    vel_map = np.where(weld, 1.0, p["vel_map"])
    stif = np.broadcast_to(np.asarray(cfg["stif_den"], np.int64),
                           (Z, X, 5)).copy()
    return Weld(veln_of(weld, domain, ang), velpn, vel_map, stif, weld,
                domain, ang)


def transducers(cfg: dict):
    """The inspection array: ``n_trans`` elements ``gap`` cells apart
    centred on the top and on the bottom row, and the top -> bottom pair
    matrix.  Returns (sx, sy, pairs), positions in metres."""
    nnz, nnx = cfg["shape"]
    n, gap, dnx = cfg["n_trans"], cfg["gap"], cfg["dnx"]
    center = nnx / 2
    start_x = center - gap * (n - 1) / 2
    end_x = center + gap * (n - 1) / 2
    if start_x < 0 or end_x > nnx - 1:
        raise ValueError(f"{n} transducers {gap} cells apart do not fit a "
                         f"width of {nnx}")
    xs = dnx * np.arange(start_x, end_x + gap / 2, gap)
    ys = dnx * np.array([0, nnz - 1])
    sx = np.concatenate([xs, xs])
    sy = np.concatenate([np.full(n, ys[0]), np.full(n, ys[1])])
    pairs = np.zeros((2 * n, 2 * n))
    pairs[:n, n:] = 1
    return sx, sy, pairs
