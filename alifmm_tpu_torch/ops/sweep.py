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

import dataclasses
import typing

import numpy as np
import torch

from .. import grid as gridlib
from . import stencils
from .stencils import INF, OFFSETS

__all__ = ["gs_pass", "solve_fixpoint", "slab_sweep", "Geometry",
           "SolveInfo", "CALLS"]

# Plain sweep passes and plain slab sweeps run in this process (the
# kernels' wrappers count their own launches; a run on the card shows the
# two apart).
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


def _line(band, flags, fixed_row, rep, mats, wok, wfirst, wlast, axis,
          model):
    """The new values of one grid line.  ``band``: the padded work rows
    i-2..i+2, (..., 5, W + 4); ``flags``: (7,) bool, rows i-2..i+2 inside
    the grid, then whether line i is the first and the last; ``mats``:
    ``_line_mats`` of the line."""
    W = band.shape[-1] - 4
    tt_center = band[..., 2, 2: 2 + W]
    nbr, known, inb = {}, {}, {}
    for (dz, dx) in OFFSETS:
        db, dw = (dz, dx) if axis == "z" else (dx, dz)
        v = band[..., 2 + db, 2 + dw: 2 + dw + W]
        nbr[(dz, dx)] = v
        known[(dz, dx)] = (v < INF * 0.5) & (v < tt_center)
        inb[(dz, dx)] = flags[2 + db] & wok[dw]
    line0, lineN = flags[5], flags[6]
    if axis == "z":
        edges = dict(top=line0, bottom=lineN, left=wfirst, right=wlast)
    else:
        edges = dict(left=line0, right=lineN, top=wfirst, bottom=wlast)
    veln, velpn, vel_map, stif, fbs = mats
    new = stencils.local_update(nbr, known, inb, tt_center, veln, velpn,
                                vel_map, stif, fbs, edges, model, model.dnx,
                                causal=True)
    old_center = tt_center.clone()
    acc_min = torch.minimum(old_center, new)
    acc_rep = torch.where(new < INF * 0.5, new, old_center)
    new = torch.where(rep, acc_rep, acc_min)
    return torch.where(fixed_row, old_center, new)


def _graphed_line(first, consts):
    """``_line`` captured once in a CUDA graph on static copies of its
    inputs (``first``: those of one line; ``consts``: the arguments that
    stay for the whole sweep).  Returns ``run(band, flags, fixed_row,
    mats)``, which copies a line's inputs in, replays the graph and returns
    its output buffer: the same kernels on the same values as the eager
    call, so the same bits, with a few host calls a line instead of
    hundreds."""
    def flat(band, flags, fixed_row, mats):
        return [band, flags, fixed_row, *mats[:4], *mats[4]]

    statics = [t.clone() for t in flat(*first)]
    dev = statics[0].device

    def call():
        b, f, fr, *m = statics
        return _line(b, f, fr, consts[0], (*m[:4], m[4:]), *consts[1:])

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        call()  # loads every kernel before the capture
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()

    def run(*line_inputs):
        for s, t in zip(statics, flat(*line_inputs)):
            s.copy_(t)
        graph.replay()
        return out
    return run


class Geometry(typing.NamedTuple):
    """Where a block of a larger grid lies, along the scanned lines and
    along their width: the global index of its first line and first width
    point, and the grid's true extents (None: the block's own).  The
    in-bounds masks and the edge flags of a sweep are taken in these
    global coordinates, so that a slab of a decomposed grid keeps the
    whole grid's boundary semantics (``_width_masks`` and
    ``_sweep_axis``'s slab arguments in the JAX package)."""

    scan_off: int = 0
    scan_total: int | None = None
    width_off: int = 0
    width_total: int | None = None


def _masks(L, W, geometry, dev):
    """A sweep's per-line flags (L, 7) and its width masks in global
    coordinates (see ``_line``)."""
    g = Geometry() if geometry is None else geometry
    L_tot = L if g.scan_total is None else g.scan_total
    W_tot = W if g.width_total is None else g.width_total
    iw = torch.arange(W, device=dev) + g.width_off
    wok = {d: (iw + d >= 0) & (iw + d <= W_tot - 1) for d in (-2, -1, 0, 1, 2)}
    il = torch.arange(L, device=dev)[:, None] + g.scan_off
    flags = torch.cat([(il + d >= 0) & (il + d <= L_tot - 1)
                       for d in (-2, -1, 0, 1, 2)]
                      + [il == 0, il == L_tot - 1], dim=1)
    return flags, wok, iw == 0, iw == W_tot - 1


def _stacked(models, tts, geometries, L, W):
    """Blocks on one device as one: their models with a leading block axis
    (and unit axes for the fields' batch dims) on every per-cell field,
    and their masks likewise, so that one ``_line`` call updates a line of
    every block with the operations it would take alone."""
    lead = (len(tts),) + (1,) * (tts[0].dim() - 2)

    def st(name, tail):
        return torch.stack([getattr(m, name) for m in models]).reshape(
            lead + tail)
    m0 = models[0]
    model = dataclasses.replace(
        m0, veln=st("veln", m0.veln.shape[-2:]),
        velpn=st("velpn", m0.velpn.shape[-2:]),
        vel_map=st("vel_map", m0.vel_map.shape[-2:]),
        stif=st("stif", m0.stif.shape[-3:]),
        fallback_slowness=st("fallback_slowness",
                             m0.fallback_slowness.shape[-3:]))
    masks = [_masks(L, W, g, tts[0].device) for g in geometries]
    flags = torch.stack([mk[0] for mk in masks], dim=-1).reshape(
        (L, 7) + lead + (1,))
    wok = {d: torch.stack([mk[1][d] for mk in masks]).reshape(lead + (W,))
           for d in (-2, -1, 0, 1, 2)}
    first, last = (torch.stack([mk[j] for mk in masks]).reshape(lead + (W,))
                   for j in (2, 3))
    return model, (flags, wok, first, last)


def _sweep_blocks(tts, models, fixeds, axis, rev, replace, graphed=False,
                  geometries=None, neighbours=None):
    """One directional Gauss-Seidel sweep along ``axis`` over blocks of the
    same shape, line by line in lockstep; ``replace`` is a bool tensor
    broadcasting against the source batch; ``graphed``: see ``gs_pass``;
    ``geometries``: a ``Geometry`` per block (None: each block is a whole
    grid).  The blocks are swept in a padded copy that is updated in
    place: lines behind the current one hold this sweep's values.  Blocks
    on one device are stacked and updated together (``_stacked``).

    ``neighbours``: None, or per block the indices (before, after) of the
    blocks beside it across the lines' width (None at the grid's edge).
    Then, once line i of every block is updated, its two halo slots at
    each end of the width are spliced from the neighbours' freshly
    updated boundary points of line i (INF at the grid's edge), as the
    JAX package's ``refresh_carry`` does, so that the next line reads the
    values one sweep over the whole grid would have given it."""
    if axis == "x":
        tts = [t.transpose(-1, -2) for t in tts]
        fixeds = [f.transpose(-1, -2) for f in fixeds]
    L, W = tts[0].shape[-2], tts[0].shape[-1]
    if any(t.shape != tts[0].shape for t in tts):
        raise ValueError("the blocks of one sweep must have one shape")
    geometries = geometries or [None] * len(tts)
    if len(tts) > 1 and len({t.device for t in tts}) == 1:
        model, masks = _stacked(models, tts, geometries, L, W)
        groups = [(torch.stack(tts), model, torch.stack(fixeds), masks)]
    else:
        groups = [(t, m, f, _masks(L, W, g, t.device))
                  for t, m, f, g in zip(tts, models, fixeds, geometries)]
    units = []
    for tt, model, fixed, (flags, wok, wfirst, wlast) in groups:
        work = torch.nn.functional.pad(tt, (2, 2, 2, 2), value=INF)
        consts = (replace.reshape(replace.shape + (1,)).to(tt.device), wok,
                  wfirst, wlast, axis, model)

        def inputs(i, work=work, flags=flags, fixed=fixed, model=model):
            return (work[..., i: i + 5, :], flags[i], fixed[..., i, :],
                    _line_mats(model, axis, i))
        units.append((work, inputs, consts))
    works = (list(units[0][0]) if len(groups) == 1 and len(tts) > 1
             else [u[0] for u in units])
    lines = range(L - 1, -1, -1) if rev else range(L)
    runs = ([_graphed_line(inputs(lines[0]), consts)
             for _, inputs, consts in units] if graphed else None)
    for i in lines:
        for k, (work, inputs, consts) in enumerate(units):
            band, fl, frow, mats = inputs(i)
            work[..., i + 2, 2: 2 + W] = (
                runs[k](band, fl, frow, mats) if graphed
                else _line(band, fl, frow, consts[0], mats, *consts[1:]))
        if neighbours is not None:
            _refresh(works, neighbours, i + 2, W)
    outs = [work[..., 2:-2, 2:-2] for work in works]
    return [o.transpose(-1, -2) for o in outs] if axis == "x" else outs


def _refresh(works, neighbours, r, W):
    """Splice padded line ``r`` of each block's halo slots (width 0-1 and
    W-2..W-1) from the neighbours' boundary points (W-4..W-3 of the block
    before, 2-3 of the block after), or INF at the grid's edge."""
    for work, (before, after) in zip(works, neighbours):
        lo = work[..., r, 2: 4]
        hi = work[..., r, W: W + 2]
        if before is None:
            lo.fill_(INF)
        else:
            lo.copy_(works[before][..., r, W - 2: W])
        if after is None:
            hi.fill_(INF)
        else:
            hi.copy_(works[after][..., r, 4: 6])


def _sweep(tt, model, fixed, axis, rev, replace, graphed=False):
    """One directional Gauss-Seidel sweep along ``axis`` over one whole
    grid; see ``_sweep_blocks``."""
    return _sweep_blocks([tt], [model], [fixed], axis, rev, replace,
                         graphed)[0]


def slab_sweep(blocks, models, fixeds, axis, rev, replace, geometries,
               neighbours=None, graphed=False):
    """The plain twin of the slab sweep kernel K5 (``ops/cuda_sweep
    .slab_sweep``): one directional sweep (``axis`` "z" or "x", ``rev``,
    min or ``replace``) over blocks of a decomposed grid, each (B, Zb, Xb)
    with its halo rows and columns marked fixed, in global coordinates
    (``geometries``), with the per-line halo refresh across ``neighbours``
    (see ``_sweep_blocks``).  Returns the new blocks.  Counterpart of the
    JAX package's ``_sweep_axis`` with its slab arguments and
    ``halo_axis``."""
    global CALLS
    CALLS += 1
    replace = torch.as_tensor(replace, device=blocks[0].device)
    return [o.contiguous() for o in _sweep_blocks(
        blocks, models, fixeds, axis, rev, replace, graphed, geometries,
        neighbours)]


def gs_pass(tt, model: gridlib.Model, fixed, replace=False, block: int = 1,
            inner: int = 0, use_ali: bool = True, use_fd: bool = True,
            graphed: bool = False):
    """One full pass (z-fwd, z-rev, x-fwd, x-rev) over ``tt`` (..., Z, X).
    ``replace`` is a bool or a bool tensor per source (phase-2 replace vs
    phase-1 min accumulation).  ``model`` may carry a leading batch of
    per-source material fields.  ``graphed`` (CUDA fields only) replays
    each line's operations from a CUDA graph: the same result with far
    less host time, for checking the kernel on large grids."""
    global CALLS
    check_form(inner=inner, use_ali=use_ali, polish_use_fd=use_fd)
    if graphed and not tt.is_cuda:
        raise ValueError("a graphed pass needs CUDA fields")
    CALLS += 1
    replace = torch.as_tensor(replace, device=tt.device)
    for axis, rev in (("z", False), ("z", True), ("x", False), ("x", True)):
        tt = _sweep(tt, model, fixed, axis, rev, replace, graphed)
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
    together.  ``tt0`` may also be a list of source chunks (the sharded
    solve), handed to ``pass_fn`` as it is, with the flags of all chunks'
    sources in order.  Returns (field, SolveInfo).
    """
    chunks = tt0 if isinstance(tt0, (list, tuple)) else [tt0]
    B = sum(c.shape[0] for c in chunks)
    G = B if per_source else 1
    mp2 = polish_passes if max_polish_passes is None else max_polish_passes
    npdt = torch.empty((), dtype=chunks[0].dtype).numpy().dtype
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


def plain_pass(tt, model, fixed, replace, active, graphed=False):
    """One plain pass in the ``two_phase`` protocol (``graphed``: see
    ``gs_pass``)."""
    rep = torch.as_tensor(replace, device=tt.device)
    new = gs_pass(tt, model, fixed, replace=rep, graphed=graphed)
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
