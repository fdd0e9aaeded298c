"""The yardstick: K1's operations and bytes, the H100's peaks, and the
device's busy time from a profiler trace.

Frozen copies, so that a share reads the same work whatever implements K1:
- ``OPS_PER_UPDATE``, ``OPS_PHASE_*``, ``PEAK_FP32``, ``PEAK_BYTES``:
  ``chip_smoke.py`` lines 280-298 (hand-counted from
  ``alifmm_tpu_torch/csrc/sweep.cu``; the peaks are the SXM data sheet's at
  700 W);
- ``point_ops``: ``chip_smoke.update_ops`` (lines 1587-1601), on a
  material map instead of packed planes;
- ``pass_bound_s``: ``chip_smoke.bound_ms`` (lines 1617-1631), for the
  sources a launch updates, in seconds;
- ``busy_intervals``/``busy_share``: ``chip_smoke.busy_share`` (lines
  2791-2812), on parsed trace events.
"""

from __future__ import annotations

import torch

__all__ = ["OPS_PER_UPDATE", "PEAK_FP32", "PEAK_BYTES", "point_ops",
           "pass_bound_s", "device_events", "busy_intervals", "busy_share"]

# fp32 operations of one point's update in K1 (csrc/sweep.cu): 8 square
# stencils ~31, 8 triangular ~35, 8 FD quadrants ~30, 8 knight pairs ~20,
# then atan, two floor-mods and the phase velocity; the phase velocity by
# its path: the closed-form Christoffel eigenvalue ~85, an interpolated
# table column ~30, a constant column 3
OPS_PER_UPDATE = 1000
OPS_PHASE_EIGEN, OPS_PHASE_LOOKUP, OPS_PHASE_CONSTANT = 85, 30, 3
# the H100's fp32 rate outside the tensor cores and its memory rate (SXM
# data sheet, at the 700 W power limit)
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12
# K1's material planes a point: veln, velpn, vel_map, 5 stiffness values,
# 4 fallback slownesses
PLANES = 12


def point_ops(velpn, has_stif: bool, const_cols):
    """Operations of one point's update, by the path its phase velocity
    takes: the Christoffel eigenvalue where ``velpn`` is 0 and the model
    has stiffness, the constant lookup for a column in ``const_cols``, the
    interpolated lookup otherwise."""
    base = OPS_PER_UPDATE - OPS_PHASE_EIGEN
    const = torch.zeros_like(velpn, dtype=torch.bool)
    for c in const_cols:
        const |= velpn == int(c)
    ops = torch.where(const, base + OPS_PHASE_CONSTANT,
                      base + OPS_PHASE_LOOKUP)
    if has_stif:
        ops = torch.where(velpn == 0, OPS_PER_UPDATE, ops)
    return ops


def pass_bound_s(free_ops, n_sources: int, Z: int, X: int, planes_b: int,
                 item: int):
    """The least time one K1 pass could take on an H100: the larger of its
    fp32 operations over ``PEAK_FP32`` and its bytes over ``PEAK_BYTES``.
    ``free_ops``: the summed ``point_ops`` of the points that are not fixed
    in the sources it updates; 4 sweeps a pass.  Bytes: those sources'
    fields read and written once, their fixed masks and ``planes_b``
    batches of the material planes read once."""
    ops = 4.0 * float(free_ops)
    nbytes = (2 * n_sources * Z * X * item + n_sources * Z * X
              + planes_b * PLANES * Z * X * item)
    return max(ops / PEAK_FP32, nbytes / PEAK_BYTES)


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_events(events):
    """(start_us, end_us, name) of every kernel, copy and fill on the
    device, sorted by start."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e.get("name", "")) for e in events
                  if e.get("ph") == "X" and "dur" in e
                  and e.get("cat") in _DEVICE_CATS)


def busy_intervals(dev):
    """The device's busy intervals (start_us, end_us): overlapping device
    events merged."""
    out = []
    for a, b, _ in dev:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_share(events, t0_us: float, t1_us: float):
    """(busy seconds, window seconds) of the device between t0 and t1
    (microseconds on the trace's clock): the time in which a kernel, copy
    or fill ran, overlaps counted once.  None without device events."""
    dev = device_events(events)
    if not dev:
        return None
    busy = 0.0
    for a, b in busy_intervals(dev):
        a, b = max(a, t0_us), min(b, t1_us)
        busy += max(0.0, b - a)
    return busy / 1e6, (t1_us - t0_us) / 1e6


def top_device_ops(events, n: int = 10):
    """The ``n`` device operations with the most device time, by name:
    [[name, seconds], ...]."""
    by = {}
    for a, b, name in device_events(events):
        by[name] = by.get(name, 0.0) + (b - a) / 1e6
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], s] for name, s in top]
