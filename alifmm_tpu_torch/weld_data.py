"""Seeded procedural weld workload (numpy only).

The production workload is the reference's weld inspection: a 424 x 500
anisotropic weld model at ``dnx = 2e-4`` m, 31 transducers on top and 31 on
the bottom, top-to-bottom pairs only (961 rays, 31 receiver fields).  The
reference's measured orientation maps are not part of this repository, so
this module builds a model of the same shape and make-up from a seed:

* parent metal: ``velpn = 1`` (isotropic table column), ``vel_map =
  5790.0`` m/s, ``veln = 0``;
* weld metal: ``velpn = 0`` (Christoffel solve on the stiffness row),
  ``vel_map = 1.0``, inside a V-shaped trapezoid about the centre column
  that covers about 61 % of the grid;
* the weld is split into 9 orientation domains (3 depth bands x 3 lateral
  bands) with integer ``veln`` in [0, 180): columnar grains tilt towards
  the centre line, mirrored left and right, vertical in the middle;
* stiffness rows from ``bench_data/weld_stif_den.npy`` (one austenite row,
  c22, c23, c33, c44 in MPa and density).
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["SHAPE", "DNX", "SUBGRID", "weld_model_arrays", "transducers",
           "ray_pairs", "workload"]

SHAPE = (424, 500)
DNX = 2e-4
SUBGRID = 9
_STIF_FILE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench_data", "weld_stif_den.npy")
# fraction of the width the weld spans at the top and at the bottom
_TOP_FRAC, _BOT_FRAC = 0.94, 0.28


def _stiffness(shape):
    stif = np.load(_STIF_FILE)
    rows = np.unique(stif.reshape(-1, 5), axis=0)
    if stif.shape[:2] == tuple(shape):
        return stif
    if rows.shape[0] != 1:
        raise ValueError("weld_stif_den.npy holds more than one row; only "
                         "its own shape is available")
    return np.broadcast_to(rows[0], tuple(shape) + (5,)).copy()


def weld_model_arrays(seed: int = 0, shape=SHAPE):
    """(veln, velpn, vel_map, stif) of a procedural weld of ``shape``."""
    rng = np.random.default_rng(seed)
    Z, X = shape
    zz, xx = np.meshgrid(np.arange(Z), np.arange(X), indexing="ij")
    depth = zz / max(Z - 1, 1)
    half = 0.5 * X * (_TOP_FRAC + (_BOT_FRAC - _TOP_FRAC) * depth)
    xc = 0.5 * (X - 1)
    u = (xx - xc) / half
    weld = np.abs(u) <= 1.0

    # 9 domains: depth band (0..2) x lateral band (left, centre, right)
    band = np.minimum((depth * 3).astype(int), 2)
    lat = np.where(u < -1.0 / 3.0, 0, np.where(u > 1.0 / 3.0, 2, 1))
    tilt = rng.integers(20, 60, size=3)            # grain tilt per depth band
    jitter = rng.integers(-5, 6, size=(3, 3))
    ang = np.empty((3, 3), np.int64)
    ang[:, 0] = 90 - tilt
    ang[:, 1] = 90
    ang[:, 2] = 90 + tilt
    ang = np.mod(ang + jitter, 180)
    veln = np.where(weld, ang[band, lat], 0).astype(np.float64)
    velpn = np.where(weld, 0, 1).astype(np.int64)
    vel_map = np.where(weld, 1.0, 5790.0)
    return veln, velpn, vel_map, _stiffness(shape)


def transducers(shape=SHAPE, dnx: float = DNX, n_trans: int = 31,
                gap: int = 15):
    """Array geometry of the weld inspection: ``n_trans`` elements ``gap``
    cells apart centred on the top and on the bottom row; pairs top ->
    bottom only.  Returns (sx, sy, pairs) in metres."""
    nnz, nnx = shape
    center = nnx / 2
    trans_len = gap * (n_trans - 1)
    start_x = center - trans_len / 2
    end_x = center + trans_len / 2
    if start_x < 0 or end_x > nnx - 1:
        raise ValueError(f"{n_trans} transducers {gap} cells apart do not "
                         f"fit a width of {nnx}")
    source_x = dnx * np.arange(start_x, end_x + gap / 2, gap)
    source_y = dnx * np.array([0, nnz - 1])
    sx = np.concatenate([source_x, source_x])
    sy = np.concatenate([np.full(n_trans, source_y[0]),
                         np.full(n_trans, source_y[1])])
    pairs = np.zeros((2 * n_trans, 2 * n_trans))
    pairs[:n_trans, n_trans:] = 1
    return sx, sy, pairs


def ray_pairs(sx, sy, pairs, dnx: float = DNX, subgrid: int = SUBGRID):
    """Solver and tracer inputs of a pair matrix: receiver coordinates
    (scx, scz) in metres, and per ray the fine-grid source and receiver
    points and the index of its receiver field."""
    rec = np.nonzero(pairs.sum(axis=0) > 0)[0]
    pair_i, pair_j = np.nonzero(pairs == 1)
    isx = np.round(sx / dnx)
    isy = np.round(sy / dnx)
    src_xy = np.stack([isx[pair_i] * subgrid, isy[pair_i] * subgrid], 1)
    rec_xy = np.stack([isx[pair_j] * subgrid, isy[pair_j] * subgrid], 1)
    tidx = np.searchsorted(rec, pair_j)
    return sx[rec], sy[rec], src_xy, rec_xy, tidx


def workload(seed: int = 0, shape=SHAPE, n_trans: int = 31, gap: int = 15):
    """(veln, velpn, vel_map, stif, sx, sy, pairs, dnx), in the order of
    the reference's workload function."""
    veln, velpn, vel_map, stif = weld_model_arrays(seed, shape)
    sx, sy, pairs = transducers(shape, DNX, n_trans, gap)
    return veln, velpn, vel_map, stif, sx, sy, pairs, DNX
