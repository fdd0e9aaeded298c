"""Gauss-Seidel line sweeps and the two-phase fixpoint, in plain PyTorch.

Counterpart of ``alifmm_tpu/ops/sweep.py`` and the plain twin of the sweep
kernel K1 (``ops/cuda_sweep.py``).  One pass is four directional sweeps,
z-forward, z-reverse, x-forward, x-reverse; each sweep updates one grid
line at a time with ``stencils.local_update(causal=True)``.  Lines behind
the current one already hold this sweep's values and lines ahead hold the
old ones; same-line neighbours are read from the line's old values.  The
loop over lines launches hundreds of small operations per line, so this
form is for the CPU tests and for checking the kernel.

Every form of the JAX package's sweep is here (``Form``): the full
operator (ALI with the FD fallback), the FD-only operator
(``use_ali=False``), the FD-free one (``use_fd=False``, the polish's fast
path), and the parallel-in-block sweeps (``inner`` = J > 0 with ``block``
= B >= 2: J Jacobi iterations over B lines at a time, the blocks tiling
the scan of the S x S padded square, S = max(Z, X)).  ``solve_fixpoint``
runs the single-loop two-phase form, or the two-loop form (a phase-1
envelope with its own operator and ``inner``, then a strictly ordered,
residual-driven polish) whenever the phases' operators differ or
``inner`` > 0.  With ``inner == 0``, ``block`` is an XLA dispatch knob
and changes nothing.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from .. import grid as gridlib
from . import stencils
from .stencils import INF, OFFSETS

__all__ = ["gs_pass", "gs_pass_unshared", "jacobi_pass", "solve_fixpoint",
           "slab_sweep", "Geometry", "Form", "pass_form", "phase_forms",
           "two_loop", "SolveInfo", "CALLS"]

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


class Form(typing.NamedTuple):
    """What one pass runs: the operator (``use_ali``: the ALI update,
    ``use_fd``: the FD fallback) and the line order (``inner`` = J > 0:
    J parallel iterations over blocks of ``block`` lines; 0: strict
    order, ``block`` 1).  ``pass_form`` builds it from ``gs_pass``'s
    arguments."""

    use_ali: bool = True
    use_fd: bool = True
    block: int = 1
    inner: int = 0


DEFAULT = Form()


def pass_form(block=1, inner=0, inner_use_ali=False, use_ali=True,
              use_fd=True) -> Form:
    """The ``Form`` of ``gs_pass(block, inner, inner_use_ali, use_ali,
    use_fd)``, as the JAX package's gs_pass reads them: the parallel
    iterations need blocks of at least two lines (J = ``inner`` only when
    ``block`` >= 2), and they run the FD-only operator unless
    ``inner_use_ali`` (the FD fallback always on); ``use_ali`` and
    ``use_fd`` are the strict order's operator."""
    B = max(1, int(block))
    J = int(inner) if (inner and B >= 2) else 0
    if J:
        return Form(bool(inner_use_ali), True, B, J)
    if not (use_ali or use_fd):
        raise ValueError("local_update needs at least one of use_ali/use_fd")
    return Form(bool(use_ali), bool(use_fd), 1, 0)


def phase_forms(block=1, inner=0, use_ali=True, phase1_use_ali=None,
                polish_use_fd=True):
    """(phase-1 form, polish form) of a fixpoint solve: phase 1 takes
    ``phase1_use_ali`` (None: ``use_ali``) with the FD fallback and
    ``inner``; the polish is strictly ordered with ``use_ali`` and
    ``polish_use_fd``."""
    p1 = use_ali if phase1_use_ali is None else phase1_use_ali
    return (pass_form(block, inner, False, p1, True),
            pass_form(1, 0, False, use_ali, polish_use_fd))


def two_loop(inner=0, use_ali=True, phase1_use_ali=None, polish_use_fd=True):
    """Whether the JAX package runs the fixpoint as two loops (its phase-1
    and polish bodies differ); see ``two_phase``."""
    p1 = use_ali if phase1_use_ali is None else phase1_use_ali
    return bool(inner) or p1 != use_ali or not polish_use_fd


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
          model, op=(True, True)):
    """The new values of one grid line.  ``band``: the padded work rows
    i-2..i+2, (..., 5, W + 4); ``flags``: (7,) bool, rows i-2..i+2 inside
    the grid, then whether line i is the first and the last; ``mats``:
    ``_line_mats`` of the line; ``op``: (use_ali, use_fd).  A block of
    lines updated at once (the parallel-in-block sweeps) takes a line
    axis before the band's: (..., B, 5, W + 4), with flags (7, B, 1)."""
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
                                causal=True, use_ali=op[0], use_fd=op[1])
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
                  geometries=None, neighbours=None, op=(True, True)):
    """One directional Gauss-Seidel sweep along ``axis`` over blocks of the
    same shape, line by line in lockstep; ``replace`` is a bool tensor
    broadcasting against the source batch; ``graphed``: see ``gs_pass``;
    ``op``: the operator, (use_ali, use_fd); ``geometries``: a
    ``Geometry`` per block (None: each block is a whole grid).  The
    blocks are swept in a padded copy that is updated in place: lines
    behind the current one hold this sweep's values.  Blocks
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
                  wfirst, wlast, axis, model, op)

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


def _sweep(tt, model, fixed, axis, rev, replace, graphed=False,
           op=(True, True)):
    """One directional Gauss-Seidel sweep along ``axis`` over one whole
    grid; see ``_sweep_blocks``."""
    return _sweep_blocks([tt], [model], [fixed], axis, rev, replace,
                         graphed, op=op)[0]


def _block_mats(model, axis, rows):
    """Material views of the grid lines ``rows`` (a (B,) index), each
    plane with a line axis before its width: (..., B, W)."""
    fb = model.fallback_slowness
    if axis == "z":
        return (model.veln.index_select(-2, rows),
                model.velpn.index_select(-2, rows),
                model.vel_map.index_select(-2, rows),
                model.stif.index_select(-3, rows),
                [fb[..., f, :, :].index_select(-2, rows) for f in range(4)])

    def col(a):
        return a.index_select(-1, rows).transpose(-1, -2)
    return (col(model.veln), col(model.velpn), col(model.vel_map),
            model.stif.index_select(-2, rows).transpose(-3, -2),
            [col(fb[..., f, :, :]) for f in range(4)])


def _sweep_parallel(tt, model, fixed, axis, rev, replace, form, S,
                    graphed=False):
    """One directional sweep in the parallel-in-block order of the JAX
    package's gs_pass (``inner`` = J > 0, ``block`` = B): the scan of the
    S x S padded square (S = max(Z, X)) in blocks of B lines, the first
    block at the scan's start, so a reverse sweep's blocks count from line
    S - 1 and its S - L padding lines come first.  Each of the J
    iterations updates every line of the block at once from the previous
    iterate: the lines behind are the previous block's final ones, the
    lines ahead the next block's old ones, and min or replace accumulates
    against the previous iterate.  Padding lines are INF and fixed, so
    they only place the block boundaries.  One ``_line`` call (or graph
    replay) updates the B lines of an iteration."""
    if axis == "x":
        tt, fixed = tt.transpose(-1, -2), fixed.transpose(-1, -2)
    L, W = tt.shape[-2], tt.shape[-1]
    B, J = form.block, form.inner
    nb = -(-S // B)
    lo = 2 + nb * B - S  # a reverse sweep's last block reaches line S - nb B
    hi = 2 + nb * B - L  # a forward sweep's last block reaches nb B - 1
    dev = tt.device
    work = torch.nn.functional.pad(tt, (2, 2, lo, hi), value=INF)
    fx = torch.nn.functional.pad(fixed, (0, 0, lo, hi), value=True)
    _, wok, wfirst, wlast = _masks(L, W, None, dev)
    rep = replace.to(dev)
    consts = (rep.reshape(rep.shape + (1, 1)), wok, wfirst, wlast, axis,
              model, (form.use_ali, form.use_fd))

    def inputs(k):
        g = S - (k + 1) * B if rev else k * B
        rows = torch.arange(g, g + B, device=dev)
        il = rows[:, None]
        flags = torch.stack([(il + d >= 0) & (il + d <= L - 1)
                             for d in (-2, -1, 0, 1, 2)]
                            + [il == 0, il == L - 1])
        r0 = g + lo
        band = work[..., r0 - 2: r0 + B + 2, :].unfold(-2, 5, 1)
        return (g, band.transpose(-1, -2), flags, fx[..., r0: r0 + B, :],
                _block_mats(model, axis, rows.clamp(0, L - 1)))

    run = None
    for k in range(nb):
        g, band, flags, frow, mats = inputs(k)
        if graphed and run is None:
            run = _graphed_line((band, flags, frow, mats), consts)
        for _ in range(J):
            new = (run(band, flags, frow, mats) if graphed
                   else _line(band, flags, frow, consts[0], mats,
                              *consts[1:]))
            work[..., g + lo: g + lo + B, 2: 2 + W] = new
    out = work[..., lo: lo + L, 2: 2 + W]
    return out.transpose(-1, -2) if axis == "x" else out


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
            inner: int = 0, inner_use_ali: bool = False,
            use_ali: bool = True, use_fd: bool = True,
            graphed: bool = False):
    """One full pass (z-fwd, z-rev, x-fwd, x-rev) over ``tt`` (..., Z, X).
    ``replace`` is a bool or a bool tensor per source (phase-2 replace vs
    phase-1 min accumulation).  ``model`` may carry a leading batch of
    per-source material fields.

    ``use_ali``/``use_fd``: the strict order's operator (``local_update``).
    ``inner`` = J > 0 with ``block`` = B >= 2 runs the parallel-in-block
    order instead (``_sweep_parallel``), with the FD-only operator unless
    ``inner_use_ali``; with ``inner == 0``, ``block`` changes nothing.
    ``graphed`` (CUDA fields only) replays each line's (or each block
    iteration's) operations from a CUDA graph: the same result with far
    less host time, for checking the kernel on large grids."""
    global CALLS
    form = pass_form(block, inner, inner_use_ali, use_ali, use_fd)
    if graphed and not tt.is_cuda:
        raise ValueError("a graphed pass needs CUDA fields")
    CALLS += 1
    replace = torch.as_tensor(replace, device=tt.device)
    S = max(tt.shape[-2], tt.shape[-1])
    for axis, rev in (("z", False), ("z", True), ("x", False), ("x", True)):
        if form.inner:
            tt = _sweep_parallel(tt, model, fixed, axis, rev, replace, form,
                                 S, graphed)
        else:
            tt = _sweep(tt, model, fixed, axis, rev, replace, graphed,
                        op=(form.use_ali, form.use_fd))
    return tt.contiguous()


def gs_pass_unshared(tt, model: gridlib.Model, fixed, replace=False,
                     block: int = 1):
    """One strictly ordered full pass, as the JAX package's
    gs_pass_unshared (four separately compiled sweeps there, the same
    result as ``gs_pass``; ``block`` changes nothing)."""
    return gs_pass(tt, model, fixed, replace=replace)


def jacobi_pass(tt, model: gridlib.Model, fixed):
    """One whole-grid Jacobi pass of the causal update with min
    accumulation (the JAX package's jacobi_pass)."""
    return torch.minimum(tt, stencils.full_grid_update(tt, model, fixed,
                                                       causal=True))


def delta_scale(new, old):
    """Per-source pass-to-pass delta and scale of (B, Z, X) fields, as the
    convergence test of the two-phase loop reads them."""
    known = new < INF * 0.5
    d = torch.where(known | (old < INF * 0.5), torch.abs(new - old), 0.0)
    s = torch.where(known, new, 0.0)
    return d.amax(dim=(-2, -1)), s.amax(dim=(-2, -1))


def two_phase(tt0, pass_fn, per_source, rel_tol, max_passes, min_passes,
              polish_passes, max_polish_passes=None, two_loop=False):
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

    ``two_loop``: the JAX package's two-loop form (``sweep.two_loop``),
    whose phase 1 is a loop of its own: it runs no pass when
    ``max_passes`` is 0, and reports ``converged`` only for a stop that
    met ``min_passes``.  ``pass_fn`` picks each source's operator from its
    phase (``replace``).
    """
    chunks = tt0 if isinstance(tt0, (list, tuple)) else [tt0]
    B = sum(c.shape[0] for c in chunks)
    G = B if per_source else 1
    mp2 = polish_passes if max_polish_passes is None else max_polish_passes
    npdt = torch.empty((), dtype=chunks[0].dtype).numpy().dtype
    tol = npdt.type(rel_tol)
    floor = npdt.type(1e-30)
    k = np.zeros(G, np.int64)
    phase = np.full(G, int(two_loop and max_passes <= 0), np.int64)
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
        stop = (converged & (k1 >= min_passes)) if two_loop else converged
        conv = np.where(running & done1, stop, conv)
        phase = np.where(running & done1, 1, phase)
    if per_source:
        return tt, SolveInfo(passes=n1, converged=conv)
    return tt, SolveInfo(passes=int(n1[0]), converged=bool(conv[0]))


def _take_sources(model, idx):
    """``model`` with its per-source material planes (a leading batch
    axis) cut to the sources ``idx``; a shared model as it is."""
    if model.veln.dim() < 3:
        return model
    return dataclasses.replace(
        model, veln=model.veln[idx], velpn=model.velpn[idx],
        vel_map=model.vel_map[idx], stif=model.stif[idx],
        fallback_slowness=model.fallback_slowness[idx])


def plain_pass(tt, model, fixed, replace, active, graphed=False,
               form=DEFAULT):
    """One plain pass of ``form`` in the ``two_phase`` protocol, over the
    active sources only (the others keep their field; ``graphed``: see
    ``gs_pass``)."""
    act = np.asarray(active, bool)
    rep = np.array(np.broadcast_to(np.asarray(replace, bool), act.shape))
    kw = dict(block=form.block, inner=form.inner, inner_use_ali=form.use_ali,
              use_ali=form.use_ali, use_fd=form.use_fd, graphed=graphed)
    if act.all():
        new = gs_pass(tt, model, fixed,
                      replace=torch.as_tensor(rep, device=tt.device), **kw)
    else:
        idx = torch.as_tensor(np.flatnonzero(act), device=tt.device)
        new = tt.clone()
        if len(idx):
            new[idx] = gs_pass(
                tt[idx], _take_sources(model, idx), fixed[idx],
                replace=torch.as_tensor(rep[act], device=tt.device), **kw)
    delta, scale = delta_scale(new, tt)
    return new, delta.cpu().numpy(), scale.cpu().numpy()


def split_pass(tt, replace, active, forms, run):
    """One pass of a fixpoint whose phases differ in form (``forms``: the
    phase-1 and the polish form, ``phase_forms``): ``run(tt, replace,
    active, form)`` runs once for the active sources of each phase that
    has any (a per-source patch stage may hold sources of both phases in
    one pass).  Returns (field, delta, scale) as ``run`` does."""
    act = np.asarray(active, bool)
    rep = np.array(np.broadcast_to(np.asarray(replace, bool), act.shape))
    if forms[0] == forms[1]:
        return run(tt, rep, act, forms[0])
    delta = scale = None
    for form, mask in ((forms[0], act & ~rep), (forms[1], act & rep)):
        if not mask.any():
            continue
        tt, d, s = run(tt, rep, mask, form)
        delta = d if delta is None else np.where(mask, d, delta)
        scale = s if scale is None else np.where(mask, s, scale)
    if delta is None:
        return run(tt, rep, act, forms[0])
    return tt, delta, scale


def solve_fixpoint(tt0, model: gridlib.Model, fixed, rel_tol: float = 1e-6,
                   max_passes: int = 50, min_passes: int = 2,
                   polish_passes: int = 5, block: int = 1, inner: int = 0,
                   max_polish_passes: int | None = None, use_ali: bool = True,
                   phase1_use_ali: bool | None = None,
                   polish_use_fd: bool = True):
    """Two-phase fixpoint solve of (Z, X) or (B, Z, X) fields that share
    ``model``, with one joint stop test (delta and scale are maxima over
    the whole batch).  Phase 1 runs ``phase1_use_ali`` (None:
    ``use_ali``) with ``block``/``inner``, the polish ``use_ali`` with
    ``polish_use_fd``, strictly ordered (``phase_forms``, ``two_loop``).
    Returns (field, SolveInfo)."""
    forms = phase_forms(block, inner, use_ali, phase1_use_ali, polish_use_fd)
    single = tt0.dim() == 2
    tt = tt0[None] if single else tt0
    fx = fixed[None] if single else fixed

    def run(t, rep, act, form):
        return plain_pass(t, model, fx, rep, act, form=form)

    def pass_fn(t, rep, act):
        return split_pass(t, rep, act, forms, run)

    out, info = two_phase(tt, pass_fn, False, rel_tol, max_passes,
                          min_passes, polish_passes, max_polish_passes,
                          two_loop(inner, use_ali, phase1_use_ali,
                                   polish_use_fd))
    return (out[0] if single else out), info
