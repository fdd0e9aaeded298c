"""Gauss-Seidel line sweeps and the two-phase fixpoint, in plain PyTorch.

Counterpart of ``alifmm_tpu/ops/sweep.py`` and the plain twin of the sweep
kernel K1 (``ops/cuda_sweep.py``).  One pass is four directional sweeps,
z-forward, z-reverse, x-forward, x-reverse; each sweep updates one grid
line at a time with ``stencils.local_update(causal=True)``.  Lines behind
the current one already hold this sweep's values and lines ahead hold the
old ones; same-line neighbours are read from the line's old values.  The
loop over lines launches hundreds of small operations per line, so this
form is for the CPU tests and for checking the kernel.

Only the single-loop two-phase form is ported (``use_ali=True``,
``phase1_use_ali=None``, ``polish_use_fd=True``, ``inner=0``): phase 1
min-accumulates until the pass-to-pass delta falls below ``rel_tol``, then
the replace polish runs.  ``block`` is an XLA dispatch knob and is
ignored.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from .. import grid as gridlib
from . import stencils
from .stencils import INF, OFFSETS

__all__ = ["gs_pass", "solve_fixpoint", "SolveInfo", "CALLS"]

# Plain sweep passes run in this process (the kernel's wrapper counts its
# own launches; a run on the card shows the two apart).
CALLS = 0


class SolveInfo(typing.NamedTuple):
    """Convergence record of a fixpoint solve: ``passes`` is the phase-1
    pass count, ``converged`` whether phase 1 met ``rel_tol`` within its
    budget.  Scalars for a joint solve, (B,) arrays per source."""

    passes: typing.Any
    converged: typing.Any


def check_form(inner=0, use_ali=True, phase1_use_ali=None, polish_use_fd=True):
    """Raise for the sweep forms this port leaves out."""
    if inner:
        raise NotImplementedError("parallel-in-block sweeps (inner > 0)")
    if not use_ali:
        raise NotImplementedError("FD-only sweeps (use_ali=False)")
    if phase1_use_ali is not None and phase1_use_ali != use_ali:
        raise NotImplementedError("a separate phase-1 operator")
    if not polish_use_fd:
        raise NotImplementedError("polish without the FD fallback")


def _line_mats(model, axis, i):
    """Material views of grid line ``i`` (a row for z-sweeps, a column for
    x-sweeps) with the model's leading batch dims kept."""
    fb = model.fallback_slowness
    if axis == "z":
        return (model.veln[..., i, :], model.velpn[..., i, :],
                model.vel_map[..., i, :], model.stif[..., i, :, :],
                [fb[..., f, i, :] for f in range(4)])
    return (model.veln[..., :, i], model.velpn[..., :, i],
            model.vel_map[..., :, i], model.stif[..., :, i, :],
            [fb[..., f, :, i] for f in range(4)])


def _sweep(tt, model, fixed, axis, rev, replace):
    """One directional Gauss-Seidel sweep along ``axis``; ``replace`` is a
    bool tensor broadcasting against the source batch."""
    if axis == "x":
        tt = tt.transpose(-1, -2)
        fixed = fixed.transpose(-1, -2)
    L, W = tt.shape[-2], tt.shape[-1]
    dev = tt.device
    work = torch.nn.functional.pad(tt, (2, 2, 2, 2), value=INF)
    iw = torch.arange(W, device=dev)
    wok = {d: (iw + d >= 0) & (iw + d <= W - 1) for d in (-2, -1, 0, 1, 2)}
    wfirst, wlast = iw == 0, iw == W - 1
    rep = replace.reshape(replace.shape + (1,))
    for i in (range(L - 1, -1, -1) if rev else range(L)):
        band = work[..., i: i + 5, :]
        tt_center = band[..., 2, 2: 2 + W]
        z_ok = {d: torch.tensor(0 <= i + d <= L - 1, device=dev)
                for d in (-2, -1, 0, 1, 2)}
        nbr, known, inb = {}, {}, {}
        for (dz, dx) in OFFSETS:
            db, dw = (dz, dx) if axis == "z" else (dx, dz)
            v = band[..., 2 + db, 2 + dw: 2 + dw + W]
            nbr[(dz, dx)] = v
            known[(dz, dx)] = (v < INF * 0.5) & (v < tt_center)
            inb[(dz, dx)] = z_ok[db] & wok[dw]
        line0 = torch.tensor(i == 0, device=dev)
        lineN = torch.tensor(i == L - 1, device=dev)
        if axis == "z":
            edges = dict(top=line0, bottom=lineN, left=wfirst, right=wlast)
        else:
            edges = dict(left=line0, right=lineN, top=wfirst, bottom=wlast)
        veln, velpn, vel_map, stif, fbs = _line_mats(model, axis, i)
        new = stencils.local_update(nbr, known, inb, tt_center, veln, velpn,
                                    vel_map, stif, fbs, edges, model,
                                    model.dnx, causal=True)
        old_center = tt_center.clone()
        acc_min = torch.minimum(old_center, new)
        acc_rep = torch.where(new < INF * 0.5, new, old_center)
        new = torch.where(rep, acc_rep, acc_min)
        new = torch.where(fixed[..., i, :], old_center, new)
        work[..., i + 2, 2: 2 + W] = new
    out = work[..., 2:-2, 2:-2]
    return out.transpose(-1, -2) if axis == "x" else out


def gs_pass(tt, model: gridlib.Model, fixed, replace=False, block: int = 1,
            inner: int = 0, use_ali: bool = True, use_fd: bool = True):
    """One full pass (z-fwd, z-rev, x-fwd, x-rev) over ``tt`` (..., Z, X).
    ``replace`` is a bool or a bool tensor per source (phase-2 replace vs
    phase-1 min accumulation).  ``model`` may carry a leading batch of
    per-source material fields."""
    global CALLS
    check_form(inner=inner, use_ali=use_ali, polish_use_fd=use_fd)
    CALLS += 1
    replace = torch.as_tensor(replace, device=tt.device)
    for axis, rev in (("z", False), ("z", True), ("x", False), ("x", True)):
        tt = _sweep(tt, model, fixed, axis, rev, replace)
    return tt.contiguous()


def delta_scale(new, old):
    """Per-source pass-to-pass delta and scale of (B, Z, X) fields, as the
    convergence test of the two-phase loop reads them."""
    known = new < INF * 0.5
    d = torch.where(known | (old < INF * 0.5), torch.abs(new - old), 0.0)
    s = torch.where(known, new, 0.0)
    return d.amax(dim=(-2, -1)), s.amax(dim=(-2, -1))


def two_phase(tt0, pass_fn, per_source, rel_tol, max_passes, min_passes,
              polish_passes, max_polish_passes=None):
    """The two-phase fixpoint loop over batched fields (B, Z, X).

    ``pass_fn(tt, replace, active)`` runs one pass for the sources where
    ``active`` holds (the others keep their field) and returns the new
    field and per-source (delta, scale) as host arrays.  ``per_source``:
    every source keeps its own phase, pass count and stop test, and a
    finished source stays frozen while the others continue; otherwise
    delta and scale are maxima over all sources and the batch stops
    together.  Returns (field, SolveInfo).
    """
    B = tt0.shape[0]
    G = B if per_source else 1
    mp2 = polish_passes if max_polish_passes is None else max_polish_passes
    npdt = torch.empty((), dtype=tt0.dtype).numpy().dtype
    tol = npdt.type(rel_tol)
    floor = npdt.type(1e-30)
    k = np.zeros(G, np.int64)
    phase = np.zeros(G, np.int64)
    n1 = np.zeros(G, np.int64)
    conv = np.zeros(G, bool)
    tt = tt0
    while True:
        running = ~((phase >= 1) & (k >= mp2))
        if not running.any():
            break
        rep = phase == 1
        if per_source:
            rep_b, act_b = rep, running
        else:
            rep_b, act_b = np.repeat(rep, B), np.ones(B, bool)
        tt, delta, scale = pass_fn(tt, rep_b, act_b)
        if not per_source:
            delta, scale = delta.max(keepdims=True), scale.max(keepdims=True)
        converged = delta <= tol * np.maximum(scale, floor)
        k1 = k + 1
        done1 = (phase == 0) & ((k1 >= max_passes)
                                | (converged & (k1 >= min_passes)))
        done2 = (phase == 1) & ((k1 >= mp2) | (converged & (k1 >= polish_passes)))
        new_k = np.where(done1, 0, np.where(done2, mp2, k1))
        k = np.where(running, new_k, k)
        n1 = np.where(running & done1, k1, n1)
        conv = np.where(running & done1, converged, conv)
        phase = np.where(running & done1, 1, phase)
    if per_source:
        return tt, SolveInfo(passes=n1, converged=conv)
    return tt, SolveInfo(passes=int(n1[0]), converged=bool(conv[0]))


def plain_pass(tt, model, fixed, replace, active):
    """One plain pass in the ``two_phase`` protocol."""
    rep = torch.as_tensor(replace, device=tt.device)
    new = gs_pass(tt, model, fixed, replace=rep)
    act = torch.as_tensor(active, device=tt.device)[:, None, None]
    new = torch.where(act, new, tt)
    delta, scale = delta_scale(new, tt)
    return new, delta.cpu().numpy(), scale.cpu().numpy()


def solve_fixpoint(tt0, model: gridlib.Model, fixed, rel_tol: float = 1e-6,
                   max_passes: int = 50, min_passes: int = 2,
                   polish_passes: int = 5, block: int = 1, inner: int = 0,
                   max_polish_passes: int | None = None, use_ali: bool = True,
                   phase1_use_ali: bool | None = None,
                   polish_use_fd: bool = True):
    """Two-phase fixpoint solve of (Z, X) or (B, Z, X) fields that share
    ``model``, with one joint stop test (delta and scale are maxima over
    the whole batch).  Returns (field, SolveInfo)."""
    check_form(inner, use_ali, phase1_use_ali, polish_use_fd)
    single = tt0.dim() == 2
    tt = tt0[None] if single else tt0
    fx = fixed[None] if single else fixed

    def pass_fn(t, rep, act):
        return plain_pass(t, model, fx, rep, act)

    out, info = two_phase(tt, pass_fn, False, rel_tol, max_passes,
                          min_passes, polish_passes, max_polish_passes)
    return (out[0] if single else out), info
