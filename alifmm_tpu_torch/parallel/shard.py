"""Scale-out of the travel-time solve: the source batch split over a mesh,
and the grid split into slabs with halo exchanges.

Counterpart of ``alifmm_tpu/parallel/shard.py``:

* ``solve_ttf_sharded`` -- the source batch split over the mesh's source
  entries: each solves its sources' patch stages on its device, and the
  final stage runs on every entry with one joint stop test (delta and
  scale are maxima over all entries, and over the process group), so the
  pass counts and the fields are those of the unsharded solve;
* ``trace_rays_sharded`` -- the ray batch split the same way, the fields
  replicated;
* ``solve_halo_sharded`` -- for grids larger than one card: the grid split
  in z slabs (or z and x blocks) over the mesh, each with two halo rows
  (and columns) on each side; every directional sweep is pipelined along
  the mesh axis it scans and refreshed line by line across the other, so
  that every update reads exactly the values the single-device sweep
  would have (the JAX package's ``_halo_jacobi_block`` and
  ``_halo_block2d`` say why: stale halos flip the polish's stencil
  selections onto another self-consistent field).  On CUDA slabs the
  sweeps run on the slab sweep kernel K5 (``ops/cuda_sweep.SlabSweep``);
  between them the halos move by tensor copies (``copy_``), which also
  work between cards;
* ``solve_ttf_halo`` -- the telescoped solve whose final stage is the halo
  solve.

All take a ``parallel.Mesh``; one process drives all its entries.  An
entry may repeat a device (virtual ranks): each still holds its own
slab or source chunk and runs the same code as on a card of its own.
The JAX package's ``_TRACE_SHARDED_CACHE`` is a compile cache; nothing
here is compiled, so there is none.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import grid as gridlib
from .. import rays as rayslib
from .. import solver as solverlib
from ..ops import cuda_sweep, sweep
from ..ops.stencils import INF
from . import Mesh

__all__ = ["pad_sources", "solve_ttf_sharded", "trace_rays_sharded",
           "solve_halo_sharded", "solve_ttf_halo"]


def pad_sources(scx, scz, n_devices):
    """Pad a source batch to a multiple of the device count (padded entries
    duplicate source 0 and are dropped by the caller)."""
    n = len(scx)
    m = (-n) % n_devices
    if m:
        scx = np.concatenate([scx, np.repeat(scx[:1], m)])
        scz = np.concatenate([scz, np.repeat(scz[:1], m)])
    return scx, scz, n


def _model_to(model: gridlib.Model, device) -> gridlib.Model:
    """``model`` with every tensor on ``device``."""
    if model.device == torch.device(device):
        return model
    return dataclasses.replace(model, **{
        n: getattr(model, n).to(device) for n in gridlib.TENSOR_FIELDS
        if getattr(model, n) is not None})


def _group():
    """(rank, size, device) of the process group for the collectives, or
    None without one; the device is the card with NCCL, else the CPU."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    return dist.get_rank(), dist.get_world_size(), dev


def _all_max(values, group):
    """Elementwise maximum of host ``values`` over the process group."""
    import torch.distributed as dist

    t = torch.as_tensor(np.asarray(values, np.float64), device=group[2])
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.cpu().numpy()


def _all_gather(t, group):
    """The group's equal-shaped tensors ``t``, concatenated in rank order
    on ``t``'s device."""
    import torch.distributed as dist

    x = t.to(group[2]).contiguous()
    parts = [torch.empty_like(x) for _ in range(group[1])]
    dist.all_gather(parts, x)
    return torch.cat(parts).to(t.device)


def _chunks(n, mesh, axis, group):
    """The slices of a padded batch of n that this process's entries along
    ``axis`` take, with their devices."""
    devs = list(mesh.sub((axis,)))
    world, rank = (1, 0) if group is None else (group[1], group[0])
    per_proc = n // world
    per_dev = per_proc // len(devs)
    start = rank * per_proc
    return [(slice(start + k * per_dev, start + (k + 1) * per_dev), d)
            for k, d in enumerate(devs)]


def _base_stages(model, subgrid_size, cfg, stages, seed_side):
    if subgrid_size == 1:
        base = model
        if stages is None:
            stages = solverlib.coarse_stages(cfg)
            seed_side = solverlib._COARSE_SEED_SIDE
        return base, stages, seed_side, solverlib._COARSE_SEED_SIGN
    base = gridlib.refine_model(model, subgrid_size)
    if stages is None:
        stages, seed_side = solverlib.fine_stage_params(subgrid_size)
    return base, stages, seed_side, solverlib._FINE_SEED_SIGN


def _note(progress, device, stage, total, name, t0):
    """``progress(stage=, total=, name=, seconds=)`` after a stage, with
    ``device`` synchronised first, as ``solver.solve_ttf`` reports."""
    if progress is None:
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    progress(stage=stage, total=total, name=name,
             seconds=time.perf_counter() - t0)


def _patch_stages(base, scx, scz, stages, seed_side, seed_sign, cfg,
                  progress=None):
    """The telescoped patch stages: the last stage's (tt, bz, bx);
    ``progress`` is told of each."""
    total = len(stages) + 1
    t0 = time.perf_counter()
    (h0, f0) = stages[0]
    tt, bz, bx, _ = solverlib._stage_first(base, scx, scz, h0, f0, seed_side,
                                           float(seed_sign), cfg)
    _note(progress, base.device, 1, total, f"patch {f0}x (half={h0})", t0)
    for k, (h, f) in enumerate(stages[1:], start=2):
        t0 = time.perf_counter()
        tt, bz, bx, _ = solverlib._stage_next(base, scx, scz, tt, bz, bx, h,
                                              f, cfg)
        _note(progress, base.device, k, total, f"patch {f}x (half={h})", t0)
    return tt, bz, bx


def solve_ttf_sharded(model: gridlib.Model, scx, scz, mesh: Mesh,
                      axis: str = "src", subgrid_size: int = 1,
                      cfg: solverlib.SolveConfig = solverlib.SolveConfig(),
                      stages=None, seed_side=None):
    """Travel-time fields with the source batch split over ``mesh``'s
    entries along ``axis`` (and, in a process group, over its processes
    first); the model is replicated.  Each entry runs the staged solve of
    its sources on its device; the final stage's pass-to-pass delta and
    scale are maxima over every entry (and every process), so all stop
    together, as the unsharded solve does; every sweep form of ``cfg``
    runs but the multigrid start, which raises.  Returns (n_src, Z, X)
    on the first entry's device."""
    group = _group()
    world = 1 if group is None else group[1]
    scx, scz, n_real = pad_sources(np.asarray(scx, np.float64),
                                   np.asarray(scz, np.float64),
                                   mesh.size * world)
    if cfg.multigrid:
        raise NotImplementedError("the multigrid start of a source-sharded "
                                  "solve (solver.solve_ttf runs it)")
    base, stages, seed_side, seed_sign = _base_stages(
        model, int(subgrid_size), cfg, stages, seed_side)
    models, parts = {}, []
    for sl, dev in _chunks(len(scx), mesh, axis, group):
        if dev not in models:
            models[dev] = _model_to(base, dev)
        m = models[dev]
        cx = torch.as_tensor(scx[sl]).to(m.dtype).to(dev)
        cz = torch.as_tensor(scz[sl]).to(m.dtype).to(dev)
        tt, fixed = solverlib._final_inputs(m, *_patch_stages(
            m, cx, cz, stages, seed_side, seed_sign, cfg))
        parts.append((tt, fixed, m))
    packs = {dev: cuda_sweep.pack_model(m) for dev, m in models.items()
             if dev.type == "cuda"}
    forms = sweep.phase_forms(cfg.sweep_block, cfg.sweep_inner, cfg.use_ali,
                              cfg.phase1_use_ali, cfg.final_polish_fd)

    def run(chunks, rep, act, form):
        new, delta, scale = [], [], []
        o = 0
        for t, (_, fixed, m) in zip(chunks, parts):
            n = t.shape[0]
            nt, d, s = cuda_sweep.sweep_pass(
                t, m, fixed, rep[o:o + n], act[o:o + n],
                packed=packs.get(t.device), form=form)
            new.append(nt)
            delta.append(d.max())
            scale.append(s.max())
            o += n
        ds = np.array([max(delta), max(scale)])
        if group is not None:
            ds = _all_max(ds, group).astype(ds.dtype)
        return new, ds[:1], ds[1:]

    def pass_fn(chunks, rep, act):
        return sweep.split_pass(chunks, rep, act, forms, run)

    out, _ = sweep.two_phase(
        [p[0] for p in parts], pass_fn, False, min_passes=2,
        two_loop=sweep.two_loop(cfg.sweep_inner, cfg.use_ali,
                                cfg.phase1_use_ali, cfg.final_polish_fd),
        **solverlib._final_budget(cfg))
    first = parts[0][0].device
    out = torch.cat([t.to(first) for t in out])
    if group is not None:
        out = _all_gather(out, group)
    return out[:n_real]


def trace_rays_sharded(model: gridlib.Model, rec_ttf, ttf_index, source_xy,
                       receiver_xy, subgrid_size: int, mesh: Mesh,
                       axis: str = "src", mode: str = "interp", **kw):
    """The ray batch split over ``mesh``'s entries along ``axis`` (and over
    the process group first); the fields and the model are replicated and
    every entry traces its rays with ``rays.trace_rays``.  Returns what
    ``trace_rays`` returns, on the first entry's device."""
    group = _group()
    world = 1 if group is None else group[1]
    source_xy = torch.as_tensor(source_xy)
    receiver_xy = torch.as_tensor(receiver_xy)
    ttf_index = torch.as_tensor(ttf_index)
    rec_ttf = torch.as_tensor(rec_ttf)
    n = source_xy.shape[0]
    nd = mesh.shape[axis] * world
    m = (-n) % nd
    if m:
        source_xy = torch.cat([source_xy, source_xy[:1].repeat(m, 1)])
        receiver_xy = torch.cat([receiver_xy, receiver_xy[:1].repeat(m, 1)])
        ttf_index = torch.cat([ttf_index, ttf_index[:1].repeat(m)])
    outs, fields, models = [], {}, {}
    for sl, dev in _chunks(n + m, mesh, axis, group):
        if dev not in models:
            models[dev] = _model_to(model, dev)
            fields[dev] = rec_ttf.to(dev)
        outs.append(rayslib.trace_rays(
            models[dev], fields[dev], ttf_index[sl], source_xy[sl],
            receiver_xy[sl], subgrid_size, mode=mode, **kw))
    first = outs[0][0].device
    res = []
    for parts in zip(*outs):
        t = torch.cat([p.to(first) for p in parts])
        if group is not None:
            t = _all_gather(t, group)
        res.append(t[:n])
    return tuple(res)


# --------------------------------------------------------------------- #
# The halo solves
# --------------------------------------------------------------------- #

def _edge_pad(model: gridlib.Model, rows: int, cols: int) -> gridlib.Model:
    """``model`` with ``rows`` rows and ``cols`` columns appended, copies
    of its last (the JAX package's edge padding)."""
    Z, X = model.shape
    iz = torch.clamp(torch.arange(Z + rows, device=model.device), max=Z - 1)
    ix = torch.clamp(torch.arange(X + cols, device=model.device), max=X - 1)

    def pad(a, lead=0):
        a = a.index_select(a.dim() - 2 - lead, iz)
        return a.index_select(a.dim() - 1 - lead, ix)
    return dataclasses.replace(
        model, veln=pad(model.veln), velpn=pad(model.velpn),
        vel_map=pad(model.vel_map), stif=pad(model.stif, lead=1),
        fallback_slowness=pad(model.fallback_slowness), ray_curves=None,
        ray_curve_idx=None, ray_skew=None, ray_info=None, skew_info=None)


def _slab_model(model: gridlib.Model, rows, cols, wx, device):
    """The block ``rows`` x ``cols`` of ``model`` with two halo rows (and
    ``wx`` halo columns) on each side, on ``device``: halo materials veln
    0, velpn 1, vel_map 1, stiffness 1, fallback slowness 1.  Their points
    are fixed, so these values only keep the discarded arithmetic finite
    and never reach a kept value."""
    def pad(a, val, lead=0):
        a = a[(..., rows, cols) + (slice(None),) * lead]
        cfg = [0, 0] * lead + [wx, wx, 2, 2]
        return F.pad(a, cfg, value=val).to(device).contiguous()
    return dataclasses.replace(
        model, veln=pad(model.veln, 0), velpn=pad(model.velpn, 1),
        vel_map=pad(model.vel_map, 1), stif=pad(model.stif, 1, lead=1),
        fallback_slowness=pad(model.fallback_slowness, 1),
        group_tab=model.group_tab.to(device),
        phase_tab=model.phase_tab.to(device), dnx=model.dnx.to(device),
        ray_curves=None, ray_curve_idx=None, ray_skew=None, ray_info=None,
        skew_info=None)


class _Halo:
    """The state of a halo solve: (B, Zs + 4, Xs [+ 4]) blocks of the
    field on their mesh entries' devices, with their fixed masks and slab
    models, and the exchanges and sweeps between them.  ``grid`` is the
    (n_sz, n_sx) array of the entries' devices; ``plain`` runs the plain
    twin (``sweep.slab_sweep``, graphed on CUDA) even on CUDA blocks, to
    check K5."""

    def __init__(self, tt, model, fixed, grid, two_d, z_true, x_true,
                 plain=False):
        B, Z, X = tt.shape
        self.nz, self.nx = grid.shape
        self.two_d = two_d
        self.Zs, self.Xs = Z // self.nz, X // self.nx
        self.z_true = Z if z_true is None else z_true
        self.x_true = X if x_true is None else x_true
        self.plain = plain
        wx = 2 if two_d else 0
        self.keys = [(iz, ix) for iz in range(self.nz) for ix in range(self.nx)]
        self.t, self.f, self.m, self.packs = {}, {}, {}, {}
        for iz, ix in self.keys:
            dev = grid[iz, ix]
            rows = slice(iz * self.Zs, (iz + 1) * self.Zs)
            cols = slice(ix * self.Xs, (ix + 1) * self.Xs)
            k = (iz, ix)
            self.t[k] = F.pad(tt[..., rows, cols], (wx, wx, 2, 2),
                              value=INF).to(dev).contiguous()
            self.f[k] = F.pad(fixed[..., rows, cols], (wx, wx, 2, 2),
                              value=True).to(dev).contiguous()
            self.m[k] = _slab_model(model, rows, cols, wx, dev)
            if dev.type == "cuda" and not plain:
                self.packs[k] = cuda_sweep.pack_model(self.m[k])
        self.kernels = {}
        self.copies = 0
        self.copy_bytes = 0

    def _copy(self, dst, src):
        if src is None:
            dst.fill_(INF)
            return
        dst.copy_(src)
        self.copies += 1
        self.copy_bytes += src.numel() * src.element_size()

    def exchange_z(self):
        """Rows 0-1 of each block from the block above (its rows -4..-3),
        rows -2..-1 from the block below (its 2-3), INF at the grid's
        edge; full width, so halo corners travel too."""
        for iz, ix in self.keys:
            t = self.t[iz, ix]
            up = self.t[iz - 1, ix][..., -4:-2, :] if iz > 0 else None
            down = (self.t[iz + 1, ix][..., 2:4, :] if iz < self.nz - 1
                    else None)
            self._copy(t[..., 0:2, :], up)
            self._copy(t[..., -2:, :], down)

    def exchange_x(self):
        """The same for the halo columns of a 2D decomposition."""
        for iz, ix in self.keys:
            t = self.t[iz, ix]
            left = self.t[iz, ix - 1][..., :, -4:-2] if ix > 0 else None
            right = (self.t[iz, ix + 1][..., :, 2:4] if ix < self.nx - 1
                     else None)
            self._copy(t[..., :, 0:2], left)
            self._copy(t[..., :, -2:], right)

    def geometry(self, k, axis):
        """Block ``k``'s place in the grid for a sweep along ``axis``."""
        iz, ix = k
        gz = sweep.Geometry(iz * self.Zs - 2, self.z_true)
        gx = (sweep.Geometry(ix * self.Xs - 2, self.x_true) if self.two_d
              else sweep.Geometry())
        scan, width = (gz, gx) if axis == "z" else (gx, gz)
        return sweep.Geometry(scan.scan_off, scan.scan_total,
                              width.scan_off, width.scan_total)

    def sweep(self, keys, axis, rev, replace, refresh):
        """One directional sweep of the blocks ``keys`` (a line of blocks
        across the width), with the per-line halo refresh between them
        when ``refresh``."""
        keys = tuple(keys)
        nb = ([(j - 1 if j > 0 else None, j + 1 if j < len(keys) - 1
                else None) for j in range(len(keys))] if refresh else None)
        geoms = [self.geometry(k, axis) for k in keys]
        blocks = [self.t[k] for k in keys]
        fixeds = [self.f[k] for k in keys]
        if self.plain or not blocks[0].is_cuda:
            new = sweep.slab_sweep(blocks, [self.m[k] for k in keys], fixeds,
                                   axis, rev, replace, geoms, nb,
                                   graphed=blocks[0].is_cuda)
            for k, t in zip(keys, new):
                self.t[k] = t
            return
        bound = self.kernels.get((keys, axis))
        if bound is None:
            bound = self.kernels[keys, axis] = cuda_sweep.SlabSweep(
                blocks, fixeds, [self.packs[k] for k in keys], axis, geoms,
                nb)
        bound.run(rev, replace)

    def interiors(self):
        """Copies of the blocks' interiors (the round's old state)."""
        return [self.interior(k).clone() for k in self.keys]

    def interior(self, k):
        t = self.t[k]
        return t[..., 2:-2, 2:-2] if self.two_d else t[..., 2:-2, :]

    def delta(self, old):
        """The round's delta and scale over every block's interior (the JAX
        package's ``round_delta``), read to the host once."""
        first = self.t[self.keys[0]].device
        ds = []
        for k, o in zip(self.keys, old):
            d, s = sweep.delta_scale(self.interior(k), o)
            ds.append(torch.stack([d.max(), s.max()]).to(first))
        ds = torch.stack(ds).amax(0).cpu().numpy()
        return ds[0], ds[1]

    def gather(self):
        """The interiors as one (B, Z, X) field on the first block's
        device."""
        first = self.t[self.keys[0]].device
        rows = [torch.cat([self.interior((iz, ix)).to(first)
                           for ix in range(self.nx)], dim=-1)
                for iz in range(self.nz)]
        return torch.cat(rows, dim=-2)


def _order(n, rev):
    return range(n - 1, -1, -1) if rev else range(n)


def _halo_jacobi_block(h: _Halo, n_inner, replace):
    """``n_inner`` full Gauss-Seidel passes on the z-slab grid, equal to
    the single-device pass bit for bit.  The z-sweeps are pipelined
    across slabs: slab s sweeps at sub-step s, and a halo exchange after
    each sub-step hands its fresh last rows to slab s + 1 before its turn.
    The x-sweeps run on every slab at once, with each line's fresh
    boundary rows spliced into the neighbours' halo slots before the next
    line (the JAX package's ``_halo_jacobi_block`` says why both are
    needed)."""
    h.exchange_z()
    for _ in range(n_inner):
        for rev in (False, True):
            for s in _order(h.nz, rev):
                h.sweep([(s, 0)], "z", rev, replace, refresh=False)
                h.exchange_z()
        for rev in (False, True):
            h.sweep([(s, 0) for s in range(h.nz)], "x", rev, replace,
                    refresh=True)
            h.exchange_z()


def _halo_block2d(h: _Halo, n_inner, replace):
    """``n_inner`` full passes on the (z, x)-block grid, equal to the
    single-device pass bit for bit: each directional sweep is pipelined
    along the mesh axis it scans and runs on a whole line of blocks across
    the other, refreshed per line across it; both halo rings are exchanged
    before each sweep (the row exchange second for the z-sweeps, so the
    rows carry fresh corners, and first for the x-sweeps)."""
    for _ in range(n_inner):
        for rev in (False, True):
            h.exchange_x()
            h.exchange_z()
            for s in _order(h.nz, rev):
                h.sweep([(s, ix) for ix in range(h.nx)], "z", rev, replace,
                        refresh=True)
                h.exchange_z()
        for rev in (False, True):
            h.exchange_z()
            h.exchange_x()
            for s in _order(h.nx, rev):
                h.sweep([(iz, s) for iz in range(h.nz)], "x", rev, replace,
                        refresh=True)
                h.exchange_x()


def _halo_grid(mesh, axis):
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    grid = mesh.sub(axes)
    return (grid[:, None] if len(axes) == 1 else grid), len(axes) == 2


def solve_halo_sharded(tt0, model: gridlib.Model, fixed, mesh: Mesh,
                       axis="gz", n_outer: int = 8, n_inner: int = 2,
                       polish: int = 2, rel_tol: float | None = None,
                       max_outer: int = 64, max_polish: int = 16,
                       return_info: bool = False, z_true: int | None = None,
                       x_true: int | None = None):
    """Fixpoint solve of (Z, X) or (B, Z, X) fields on a grid split into z
    slabs over the mesh axis ``axis`` (Z a multiple of its size), or into
    (z, x) blocks over ``axis=("gz", "gx")``; the model is split the same
    way, the source batch is not.  A round is ``n_inner`` halo passes.

    Stopping rule:

    * ``rel_tol=None``: a fixed budget, ``n_outer`` min rounds then
      ``polish`` replace rounds; ``converged`` compares the last round's
      delta with 1e-6 of its scale.  With budgets matched to
      ``ops/sweep.solve_fixpoint``'s the field equals the single-device
      solve's bit for bit.
    * ``rel_tol=r``: the residual-driven two-phase loop
      (``ops/sweep.two_phase``): min rounds (at least 2, at most
      ``max_outer``) until the delta over every block is within r of the
      scale, then replace rounds (at least ``max(polish, 1)``, at most
      ``max_polish``) under the same test.

    ``z_true``/``x_true``: the true grid's extents when rows or columns
    were padded to a slab multiple (padded points fixed INF).  Returns the
    field on the first entry's device [and ``sweep.SolveInfo(passes,
    converged)`` with ``return_info=True``]."""
    grid, two_d = _halo_grid(mesh, axis)
    batched = tt0.dim() == 3
    tt = tt0 if batched else tt0[None]
    fx = fixed if batched else fixed[None]
    Z, X = tt.shape[-2:]
    nz, nx = grid.shape
    if Z % nz or X % nx:
        raise ValueError(f"a {Z} x {X} grid does not split into {nz} x {nx} "
                         f"blocks")
    if Z // nz < 2 or X // nx < (2 if two_d else 1):
        raise ValueError("each block needs at least two rows (and columns)")
    h = _Halo(tt, model, fx, grid, two_d, z_true, x_true)
    block = _halo_block2d if two_d else _halo_jacobi_block
    npdt = torch.empty((), dtype=tt.dtype).numpy().dtype

    if rel_tol is None:
        old = h.interiors() if n_outer + polish == 0 else None
        for k in range(n_outer + polish):
            if return_info and k == n_outer + polish - 1:
                old = h.interiors()
            block(h, n_inner, k >= n_outer)
        info = None
        if return_info:
            d, s = h.delta(old)
            conv = bool(d <= npdt.type(1e-6) * max(s, npdt.type(1e-30)))
            info = sweep.SolveInfo(passes=n_outer, converged=conv)
    else:
        def pass_fn(state, rep, act):
            old = h.interiors()
            block(h, n_inner, bool(rep[0]))
            d, s = h.delta(old)
            return state, np.array([d]), np.array([s])

        _, info = sweep.two_phase(tt, pass_fn, False, rel_tol, max_outer, 2,
                                  max(polish, 1), max_polish)
    out = h.gather()
    out = out if batched else out[0]
    return (out, info) if return_info else out


def solve_ttf_halo(model: gridlib.Model, scx, scz, mesh: Mesh, axis="gz",
                   subgrid_size: int = 1,
                   cfg: solverlib.SolveConfig = solverlib.SolveConfig(),
                   n_inner: int = 1, return_info: bool = False, stages=None,
                   seed_side=None, progress=None):
    """Telescoped travel-time solve with the final stage on the grid split
    over ``mesh`` (``axis``: one mesh axis for z slabs, two for z and x
    blocks).  The patch stages run on the model's device (K1), their
    injection seeds the final grid, whose rows (and columns) are padded to
    a multiple of the blocks with fixed INF points and edge materials, and
    the residual-driven halo solve finishes it.  ``progress(stage=,
    total=, name=, seconds=)`` is called after each stage, as
    ``solver.solve_ttf`` calls it.  Returns (n_src, Z, X) [and the final
    stage's SolveInfo with ``return_info=True``]."""
    base, stages, seed_side, seed_sign = _base_stages(
        model, int(subgrid_size), cfg, stages, seed_side)
    scx = torch.as_tensor(scx, device=base.device).to(base.dtype)
    scz = torch.as_tensor(scz, device=base.device).to(base.dtype)
    Z, X = base.shape
    last = _patch_stages(base, scx, scz, stages, seed_side, seed_sign, cfg,
                         progress)
    t0 = time.perf_counter()
    tt0, fixed = solverlib._final_inputs(base, *last)
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    n_sz = mesh.shape[axes[0]]
    n_sx = mesh.shape[axes[1]] if len(axes) == 2 else 1
    pad_rows, pad_cols = (-Z) % n_sz, (-X) % n_sx
    mdl = base
    if pad_rows or pad_cols:
        mdl = _edge_pad(base, pad_rows, pad_cols)
        tt0 = F.pad(tt0, (0, pad_cols, 0, pad_rows), value=INF)
        fixed = F.pad(fixed, (0, pad_cols, 0, pad_rows), value=True)
    budget = solverlib._final_budget(cfg)
    f_pol = budget["polish_passes"]
    max_pol = (cfg.final_max_polish if cfg.final_max_polish is not None
               else max(cfg.final_max_passes, 4 * f_pol))
    out = solve_halo_sharded(
        tt0, mdl, fixed, mesh, axis=axis, n_inner=n_inner, polish=f_pol,
        rel_tol=budget["rel_tol"], max_outer=cfg.final_max_passes,
        max_polish=max_pol, return_info=return_info,
        z_true=Z if pad_rows else None, x_true=X if pad_cols else None)
    out, info = out if return_info else (out, None)
    out = out[..., :Z, :X]
    _note(progress, out.device, len(stages) + 1, len(stages) + 1,
          "final full-grid", t0)
    return (out, info) if return_info else out
