"""K1, the sweep kernel on the GPU, the fixpoint pass loop, and K5, the
slab sweep of the decomposed grid.

Counterpart of ``alifmm_tpu/ops/pallas_sweep.py``.  ``csrc/sweep.cu`` runs
one full pass (four directional Gauss-Seidel sweeps) for a batch of
sources, a cluster of C CTAs per source with G lanes per point
(``launch_config``), and returns each source's pass-to-pass delta and
scale.  It is compiled with ``nvcc`` for ``sm_90a`` into a library
with a plain C interface at first use, into ``alifmm_tpu_torch/_build/``,
and loaded with ``ctypes`` (``ops/_build.py``).

K1's other forms (``sweep.Form``: the FD-only and the FD-free operator,
the parallel-in-block order) are a second library,
``csrc/sweep_forms.cu``, over the same device functions
(``csrc/sweep_device.cuh``), so that K1's own build does not grow.

``sweep_pass`` is the wrapper: for CUDA tensors it launches K1 (the
default form) or its form kernel (and raises on any failure), for CPU
tensors it runs the plain twin (``ops/sweep.gs_pass``).  ``LAUNCHES``
counts K1's default launches, ``FORM_LAUNCHES`` the others by form.
``solve_fixpoint`` is the two-phase pass loop the solver calls; each pass
reads the per-source delta and scale to the host (two blocking reads).
Under a profiler the loop is the range ``alifmm.fixpoint``, each pass
``alifmm.pass`` and each of its reads ``alifmm.pass.read``
(``utils/profiling.span``); ``pack_model`` is ``alifmm.pack``, with its
read of ``dnx`` as ``alifmm.pack.read``.

K5 (``csrc/sweep.cu``, same library) runs one directional sweep over the
slabs of a decomposed grid, in place, in global coordinates, with the
per-line halo refresh of the halo solves (``parallel/shard.py``), in one
launch where the slabs share a device and fit a cluster
(``slab_config``).
``slab_sweep`` is its wrapper (the plain twin ``ops/sweep.slab_sweep`` for
CPU tensors), ``SlabSweep`` binds it to a set of slabs for a whole solve,
``SLAB_LAUNCHES`` counts its launches.
"""

from __future__ import annotations

import ctypes
import os
import typing

import numpy as np
import torch

from .. import grid as gridlib
from .. import materials as mat
from ..utils.profiling import span, spanned
from . import _build, sweep

__all__ = ["LAUNCHES", "FORM_LAUNCHES", "SLAB_LAUNCHES", "build",
           "build_forms", "launch_config", "pack_model", "form_kernel",
           "sweep_pass", "solve_fixpoint", "slab_config", "SlabLayout",
           "SlabSweep", "slab_sweep"]

LAUNCHES = 0
SLAB_LAUNCHES = 0
# launches of K1's other forms, by form_kernel name
FORM_LAUNCHES = {"fd_only": 0, "fd_free": 0, "block_fd": 0,
                 "block_full": 0}

SOURCE = os.path.join(_build.CSRC, "sweep.cu")
FORMS_SOURCE = os.path.join(_build.CSRC, "sweep_forms.cu")
_LIB = None
_FORMS_LIB = None
BUILD_LOG = ""
FORMS_BUILD_LOG = ""
# Launch shapes K1 is built for (csrc/sweep.cu): clusters of up to 8 CTAs
# per source, 4 or 8 lanes per point, width tiles of up to 1,020 points.
CLUSTER_SIZES = (8, 4, 2, 1)
LANE_COUNTS = (4, 8)
MIN_TILE = 8
MAX_TILE = 1020


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def build(verbose: bool = False):
    """Compile ``csrc/sweep.cu`` (once per process and source version) and
    return the loaded library.  ``verbose`` adds ``-Xptxas -v`` and keeps
    its report in ``BUILD_LOG``."""
    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    lib, BUILD_LOG = _build.compile_library(SOURCE, "alifmm_sweep", verbose)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("alifmm_sweep_pass_f32", "alifmm_sweep_pass_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_longlong, ptr,
                       i32, ptr, ptr, i32, ctypes.c_double, ptr, ptr, ptr,
                       ptr, i32, i32, i32, i32, i32, ptr]
        fn.restype = i32
    for name in ("alifmm_slab_sweep_f32", "alifmm_slab_sweep_f64"):
        fn = getattr(lib, name)
        fn.argtypes = ([ptr] + [i32] * 12 + [ptr, i32, ptr, ptr, i32,
                                             ctypes.c_double]
                       + [i32] * 4 + [ptr])
        fn.restype = i32
    lib.alifmm_enable_peer_access.argtypes = [i32, i32]
    lib.alifmm_enable_peer_access.restype = i32
    _LIB = lib
    return lib


def build_forms(verbose: bool = False):
    """Compile ``csrc/sweep_forms.cu`` (K1's other forms) once per process
    and source version and return the loaded library; ``verbose`` as in
    ``build``, its report in ``FORMS_BUILD_LOG``."""
    global _FORMS_LIB, FORMS_BUILD_LOG
    if _FORMS_LIB is not None:
        return _FORMS_LIB
    lib, FORMS_BUILD_LOG = _build.compile_library(
        FORMS_SOURCE, "alifmm_sweep_forms", verbose)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("alifmm_sweep_forms_f32", "alifmm_sweep_forms_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_longlong, ptr,
                       i32, ptr, ptr, i32, ctypes.c_double, ptr, ptr, ptr,
                       ptr, i32, i32, i32, i32, i32, i32, i32, i32, ptr]
        fn.restype = i32
    _FORMS_LIB = lib
    return lib


# csrc/sweep_device.cuh: the operators of the form kernel
OP_FULL, OP_FD_ONLY, OP_FD_FREE = 0, 1, 2


def form_kernel(form: "sweep.Form"):
    """(name, operator, lines a block, iterations a block) of the kernel
    that runs ``form``; name None for K1's default form (``sweep.cu``)."""
    if form.inner:
        return (("block_full", OP_FULL) if form.use_ali
                else ("block_fd", OP_FD_ONLY)) + (form.block, form.inner)
    if form.use_ali and form.use_fd:
        return None, OP_FULL, 1, 1
    if form.use_ali:
        return "fd_free", OP_FD_FREE, 1, 1
    return "fd_only", OP_FD_ONLY, 1, 1


class Packed(typing.NamedTuple):
    """A model's material planes and phase table in the kernel's layout."""

    planes: torch.Tensor      # (Bm, 12, Z, X): veln, velpn, vel_map, stif x5, fbs x4
    planes_t: torch.Tensor    # (Bm, 12, X, Z): the same, for the x-sweeps
    phase_tab: torch.Tensor   # (A, M) contiguous
    col_mode: torch.Tensor    # (M,) int32
    col_const: torch.Tensor   # (M,)
    has_stif: bool
    dnx: float


@spanned("pack")
def pack_model(model: gridlib.Model) -> Packed:
    """Stack a (shared or per-source batched) model into kernel planes."""
    dt = model.dtype
    stif = model.stif
    cols = [model.veln, model.velpn.to(dt), model.vel_map]
    cols += [stif[..., c] for c in range(5)]
    cols += [model.fallback_slowness[..., f, :, :] for f in range(4)]
    planes = torch.stack(cols, dim=-3)
    if planes.dim() == 3:
        planes = planes[None]
    mode, const = mat.column_modes(model.phase_info, model.phase_tab.shape[1])
    dev = model.device
    with span("pack.read"):
        dnx = float(model.dnx)
    return Packed(
        planes=planes.contiguous(),
        planes_t=planes.transpose(-1, -2).contiguous(),
        phase_tab=model.phase_tab.contiguous(),
        col_mode=torch.from_numpy(mode).to(dev),
        col_const=torch.from_numpy(const).to(dt).to(dev),
        has_stif=bool(model.has_stif),
        dnx=dnx,
    )


def launch_config(B: int, Z: int, X: int, sms: int,
                  cluster: int | None = None, lanes: int | None = None):
    """K1's (cluster size C, lanes per point G) for B sources of (Z, X).

    A line step gives each SM about B * max(Z, X) / sms points.  Up to 32
    points per SM the step is latency-bound and G = 8 shortens it; above
    that it is bound by the SM's issue rate, and G = 4 (64 registers, two
    CTAs per SM) does less redundant work.  C is the largest of 8, 4, 2, 1
    that keeps all B x C CTAs resident at two per SM and width tiles of at
    least ``MIN_TILE`` points: C = 8 for the 31 weld sources at 424 x 500,
    109 x 109 and 79 x 79, and on the refined weld (s = 9) at 397 x 397,
    295 x 295 and 3808 x 4492.  Residency is for speed only: the CTAs of
    a cluster meet at its barriers, no CTA waits for another cluster, so
    where fewer fit (one CTA of 193 KB of shared memory per SM in float64
    at 3808 x 4492's tiles of 562 points) the clusters run in turns."""
    width = max(Z, X)
    if lanes is None:
        lanes = 8 if B * width <= 32 * sms else 4
    if cluster is None:
        cluster = 1
        for c in CLUSTER_SIZES:
            if B * c <= 2 * sms and -(-width // c) >= MIN_TILE:
                cluster = c
                break
    if cluster not in CLUSTER_SIZES or lanes not in LANE_COUNTS:
        raise ValueError(f"K1 takes clusters of {CLUSTER_SIZES} CTAs and "
                         f"{LANE_COUNTS} lanes per point, not {cluster} and "
                         f"{lanes}")
    if -(-width // cluster) > MAX_TILE:
        raise ValueError(f"K1 takes width tiles of up to {MAX_TILE} points, "
                         f"not {-(-width // cluster)} ({width} over "
                         f"{cluster} CTAs)")
    return cluster, lanes


def _launch(tt, fixed, packed, replace, active, cluster=None, lanes=None,
            form=sweep.DEFAULT):
    """Launch K1 for (B, Z, X) CUDA fields; returns (new, delta, scale).
    ``cluster``/``lanes`` override ``launch_config``'s choice; a ``form``
    other than the default launches the form kernel
    (``csrc/sweep_forms.cu``)."""
    global LAUNCHES
    if tt.dim() != 3 or fixed.shape != tt.shape:
        raise ValueError(f"K1 takes (B, Z, X) fields and a fixed mask of the "
                         f"same shape, not {tuple(tt.shape)} and "
                         f"{tuple(fixed.shape)}")
    B, Z, X = tt.shape
    dt = tt.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"K1 takes float32 or float64 fields, not {dt}")
    planes = packed.planes
    if planes.shape[-2:] != (Z, X) or planes.shape[0] not in (1, B):
        raise ValueError(f"material planes {tuple(planes.shape)} do not fit "
                         f"fields {tuple(tt.shape)}")
    for name, t in (("fixed", fixed), ("planes", planes),
                    ("phase_tab", packed.phase_tab)):
        if t.device != tt.device:
            raise ValueError(f"{name} is on {t.device}, fields on {tt.device}")
    if planes.dtype != dt or packed.phase_tab.dtype != dt:
        raise TypeError("material planes and fields differ in dtype")
    tt = tt.contiguous()
    fixed = fixed.to(torch.bool).contiguous()
    C, G = launch_config(B, Z, X, _sm_count(tt.device), cluster, lanes)
    out = torch.empty_like(tt)
    scratch = torch.empty_like(tt)
    delta = torch.empty(B, dtype=dt, device=tt.device)
    scale = torch.empty(B, dtype=dt, device=tt.device)
    rep = torch.as_tensor(np.asarray(replace, np.int32)).to(tt.device)
    act = torch.as_tensor(np.asarray(active, np.int32)).to(tt.device)
    bstride = 0 if planes.shape[0] == 1 else planes[0].numel()
    name, op, nb, iters = form_kernel(form)
    args = (tt.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            fixed.data_ptr(), planes.data_ptr(), packed.planes_t.data_ptr(),
            bstride, packed.phase_tab.data_ptr(),
            packed.phase_tab.shape[1], packed.col_mode.data_ptr(),
            packed.col_const.data_ptr(), int(packed.has_stif), packed.dnx,
            rep.data_ptr(), act.data_ptr(), delta.data_ptr(),
            scale.data_ptr(), B, Z, X, C, G)
    stream = torch.cuda.current_stream(tt.device).cuda_stream
    f32 = dt == torch.float32
    if name is None:
        lib = build()
        fn = lib.alifmm_sweep_pass_f32 if f32 else lib.alifmm_sweep_pass_f64
        err = fn(*args, stream)
    else:
        lib = build_forms()
        fn = lib.alifmm_sweep_forms_f32 if f32 else lib.alifmm_sweep_forms_f64
        err = fn(*args, op, nb, iters, stream)
    if err != 0:
        raise RuntimeError(f"K1 ({name or 'default'} form) launch failed: "
                           f"CUDA error {err}")
    if name is None:
        LAUNCHES += 1
    else:
        FORM_LAUNCHES[name] += 1
    return out, delta, scale


@spanned("pass")
def sweep_pass(tt, model: gridlib.Model, fixed, replace, active=None,
               packed: Packed | None = None, form=sweep.DEFAULT):
    """One sweep pass of ``form`` (``sweep.Form``) over (B, Z, X) fields:
    K1 on a CUDA tensor, the plain twin on a CPU tensor.
    ``replace``/``active``: per-source flags (inactive sources keep their
    field).  Returns (new, delta, scale) with per-source delta and scale
    as host arrays: on the card two blocking reads, each the range
    ``alifmm.pass.read`` inside the pass's ``alifmm.pass``."""
    B = tt.shape[0]
    replace = np.array(np.broadcast_to(np.asarray(replace, bool), (B,)))
    active = (np.ones(B, bool) if active is None
              else np.array(np.broadcast_to(np.asarray(active, bool), (B,))))
    if not tt.is_cuda:
        return sweep.plain_pass(tt, model, fixed, replace, active, form=form)
    packed = pack_model(model) if packed is None else packed
    out, delta, scale = _launch(tt, fixed, packed, replace, active,
                                form=form)
    with span("pass.read"):
        delta = delta.cpu()
    with span("pass.read"):
        scale = scale.cpu()
    return out, delta.numpy(), scale.numpy()


@spanned("fixpoint")
def solve_fixpoint(tt0, model: gridlib.Model, fixed, rel_tol: float = 1e-6,
                   max_passes: int = 50, min_passes: int = 2,
                   polish_passes: int = 5, max_polish_passes: int | None = None,
                   per_source: bool = False, block: int = 1, inner: int = 0,
                   use_ali: bool = True, phase1_use_ali: bool | None = None,
                   polish_use_fd: bool = True):
    """Two-phase fixpoint solve of (B, Z, X) fields through ``sweep_pass``.

    ``per_source=False``: one joint stop test over the batch (the final
    stage).  ``per_source=True``: each source has its own phase, pass count
    and stop test, and ``model`` may carry per-source material fields (the
    patch stages); a pass then runs each phase's form on its sources.
    The forms and the two-loop stop rules are ``ops/sweep.solve_fixpoint``'s
    (``phase_forms``, ``two_loop``).  Returns (field, SolveInfo)."""
    forms = sweep.phase_forms(block, inner, use_ali, phase1_use_ali,
                              polish_use_fd)
    packed = pack_model(model) if tt0.is_cuda else None

    def run(tt, rep, act, form):
        return sweep_pass(tt, model, fixed, rep, act, packed=packed,
                          form=form)

    def pass_fn(tt, rep, act):
        return sweep.split_pass(tt, rep, act, forms, run)

    return sweep.two_phase(tt0, pass_fn, per_source, rel_tol, max_passes,
                           min_passes, polish_passes, max_polish_passes,
                           sweep.two_loop(inner, use_ali, phase1_use_ali,
                                          polish_use_fd))


# --------------------------------------------------------------------- #
# K5: the slab sweep of the halo solves
# --------------------------------------------------------------------- #

MAX_SLABS = 16  # slabs in one K5 launch (csrc/sweep.cu, kMaxSlabs)
MAX_CLUSTER = 8  # CTAs in one cluster (csrc/sweep.cu, kMaxCluster)


class _SlabEntry(ctypes.Structure):
    """csrc/sweep.cu's SlabEntry: one slab of a K5 launch."""

    _fields_ = [("field", ctypes.c_void_p), ("fixed", ctypes.c_void_p),
                ("mats", ctypes.c_void_p), ("mats_t", ctypes.c_void_p),
                ("before", ctypes.c_void_p), ("after", ctypes.c_void_p),
                ("scan_off", ctypes.c_int), ("width_off", ctypes.c_int)]


class SlabLayout(typing.NamedTuple):
    """K5's launch layout for one sweep (``slab_config``)."""

    per_line: bool  # the per-line schedule: a launch a line
    blocks: int     # slabs in one cluster: the line of blocks, or 1
    cluster: int    # CTAs a slab (its width tiles), c
    lanes: int      # lanes per point, G


def slab_config(B: int, n_blocks: int, W: int, sms: int, devices: int = 1,
                refresh: bool = True, per_line: bool = False,
                cluster: int | None = None,
                lanes: int | None = None) -> SlabLayout:
    """K5's layout for one sweep over ``n_blocks`` slabs of B sources with
    lines W wide, on ``devices`` devices; ``refresh``: the slabs are a line
    of neighbours across the width whose halo slots each line refreshes.

    A refreshed sweep is one launch, each source's cluster holding the
    whole line of blocks (``blocks`` = n_blocks, the slots passed through
    distributed shared memory), when the blocks share one device and fit
    one cluster: n_blocks x c <= 8 with tiles of at most ``MAX_TILE``
    points.  Otherwise (blocks on several devices, more than 8 on one, or
    ``per_line``, which only the checks pass) it keeps the per-line
    schedule: a launch a line, a cluster a block.  A sweep without refresh
    is one launch, a cluster a block.

    c, the CTAs a block, follows K1's rule (``launch_config``): the
    largest of 8, 4, 2, 1 within the cluster that keeps every CTA resident
    at two an SM with tiles of ``MIN_TILE`` to ``MAX_TILE`` points (c = 1
    whenever its tile fits); G = 8 where a line step is latency-bound.
    The weld's four slabs (W = 110) take c = 2, its 2 x 2 blocks (W = 254
    and 216) c = 4, the fine weld's four slabs (W = 956) c = 2.
    ``cluster``/``lanes`` force c (any that fits the cluster: ragged
    tiles) and G, for the checks."""
    if lanes is None:
        lanes = 8 if B * n_blocks * W <= 32 * sms else 4
    if lanes not in LANE_COUNTS:
        raise ValueError(f"K5 takes {LANE_COUNTS} lanes per point, not "
                         f"{lanes}")

    def tiles(nb):
        for c in (CLUSTER_SIZES if cluster is None else (cluster,)):
            tile = -(-W // c)
            if 1 <= nb * c <= MAX_CLUSTER and tile <= MAX_TILE and (
                    c == 1 or cluster is not None
                    or (B * n_blocks * c <= 2 * sms and tile >= MIN_TILE)):
                return c
        return None

    one = refresh and not (per_line or devices > 1
                           or n_blocks > MAX_CLUSTER)
    c = tiles(n_blocks) if one else None
    if c is not None:
        return SlabLayout(False, n_blocks, c, lanes)
    c = tiles(1)
    if c is None:
        raise ValueError(f"K5 takes lines of up to {MAX_CLUSTER * MAX_TILE} "
                         f"points in clusters of up to {MAX_CLUSTER} CTAs, "
                         f"not {W} points in {cluster or 'any'}")
    return SlabLayout(refresh, 1, c, lanes)


class SlabSweep:
    """K5 bound to same-shaped slabs (B, Zm, Xm) that it updates in place,
    with their fixed masks, packed models (``pack_model``) and, for one
    sweep axis, their ``sweep.Geometry`` and halo ``neighbours`` (see
    ``sweep._sweep_blocks``; None: no per-line refresh).  ``run(rev,
    replace)`` sweeps every line.

    ``slab_config`` picks the schedule by shape.  A sweep without
    neighbours is one launch, a cluster a slab (up to ``MAX_SLABS`` slabs
    a launch).  A refreshed sweep whose line of blocks shares one device
    and fits one cluster is one launch too: each source's cluster spans
    the line of blocks and passes every finished line's halo slots
    between its CTAs through distributed shared memory.  Otherwise it is
    a launch a line, each refreshing the line before it from the
    neighbours' memory, and one that refreshes the last
    (``per_line=True`` forces this for the checks, as ``cluster`` and
    ``lanes`` force c and G); slabs on several devices then meet after
    every launch (events) and read each other through peer access.  A
    line step is K1's, so a one-launch sweep takes about what K1 takes
    for the same lines at the same width (about 5.5 us a line at the
    weld's final stage on the H100); the per-line schedule is bound by
    the host's launch (about 13 us a line)."""

    def __init__(self, blocks, fixeds, packs, axis, geometries,
                 neighbours=None, per_line=False, cluster=None, lanes=None):
        t0 = blocks[0]
        if t0.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"K5 takes float32 or float64 fields, not "
                            f"{t0.dtype}")
        B, Zm, Xm = t0.shape
        self.xs = axis == "x"
        self.L = Xm if self.xs else Zm
        W = Zm if self.xs else Xm
        g0 = geometries[0]
        totals = (g0.scan_total or self.L, g0.width_total or W)
        for t, f, p, g in zip(blocks, fixeds, packs, geometries):
            if (t.shape != t0.shape or f.shape != t0.shape
                    or t.dtype != t0.dtype or not t.is_cuda
                    or not t.is_contiguous()):
                raise ValueError("K5 takes contiguous CUDA slabs of one "
                                 "shape and type with fixed masks alike")
            if (f.dtype != torch.bool or not f.is_contiguous()
                    or f.device != t.device or p.planes.device != t.device):
                raise ValueError("a slab's fixed mask and planes must be "
                                 "contiguous, on its device")
            if p.planes.shape != (1, 12, Zm, Xm) or p.planes.dtype != t.dtype:
                raise ValueError(f"slab planes {tuple(p.planes.shape)} do "
                                 f"not fit slabs {tuple(t0.shape)}")
            if (g.scan_total or self.L, g.width_total or W) != totals:
                raise ValueError("the slabs of one launch share the grid's "
                                 "extents")
        self.blocks = blocks
        self.neighbours = neighbours
        self.totals = totals
        lib = build()
        self.fn = (lib.alifmm_slab_sweep_f32 if t0.dtype == torch.float32
                   else lib.alifmm_slab_sweep_f64)
        p0 = packs[0]
        self.tables = (p0.phase_tab.data_ptr(), p0.phase_tab.shape[1],
                       p0.col_mode.data_ptr(), p0.col_const.data_ptr(),
                       int(p0.has_stif), p0.dnx)
        self.shape = (B, Zm, Xm)
        devices = []
        for t in blocks:
            if t.device not in devices:
                devices.append(t.device)
        refresh = neighbours is not None
        # the cluster passes slots between consecutive blocks only
        chain = [(k - 1 if k else None, k + 1 if k < len(blocks) - 1
                  else None) for k in range(len(blocks))]
        self.layout = slab_config(
            B, len(blocks), W, _sm_count(devices[0]), len(devices), refresh,
            per_line or (refresh and list(map(tuple, neighbours)) != chain),
            cluster, lanes)
        self.link = int(refresh and not self.layout.per_line)
        self.groups = []
        for dev in devices:
            ks = [k for k, t in enumerate(blocks) if t.device == dev]
            launches = []
            for c in range(0, len(ks), MAX_SLABS):
                part = ks[c: c + MAX_SLABS]
                entries = (_SlabEntry * len(part))(*[
                    self._entry(k, fixeds[k], packs[k], geometries[k], dev)
                    for k in part])
                launches.append((entries, len(part)))
            self.groups.append((dev, launches))

    def _entry(self, k, fixed, packed, geom, dev):
        before, after = (None, None) if self.neighbours is None \
            else self.neighbours[k]
        ptrs = []
        for j in (before, after):
            if j is None:
                ptrs.append(None)
                continue
            other = self.blocks[j].device
            if other != dev:
                err = build().alifmm_enable_peer_access(dev.index,
                                                        other.index)
                if err != 0:
                    raise RuntimeError(f"K5: {dev} cannot read {other} "
                                       f"(CUDA error {err})")
            ptrs.append(self.blocks[j].data_ptr())
        return _SlabEntry(self.blocks[k].data_ptr(), fixed.data_ptr(),
                          packed.planes.data_ptr(), packed.planes_t.data_ptr(),
                          ptrs[0], ptrs[1], int(geom.scan_off),
                          int(geom.width_off))

    def _streams(self):
        """Each device's current stream, read once a sweep (the per-line
        schedule's cost is the host's)."""
        return [torch.cuda.current_stream(dev) for dev, _ in self.groups]

    def _launch(self, streams, l0, n_lines, step, refresh, replace):
        global SLAB_LAUNCHES
        B, Zm, Xm = self.shape
        lay = self.layout
        home = torch.cuda.current_device()
        for (dev, launches), stream in zip(self.groups, streams):
            if dev.index != home:
                torch.cuda.set_device(dev)
            for entries, n in launches:
                err = self.fn(ctypes.addressof(entries), n, B, Zm, Xm,
                              int(self.xs), l0, n_lines, step, refresh,
                              int(bool(replace)), *self.totals,
                              *self.tables, lay.blocks, self.link,
                              lay.cluster, lay.lanes, stream.cuda_stream)
                if err != 0:
                    raise RuntimeError(f"K5 launch failed: CUDA error {err}")
                SLAB_LAUNCHES += 1
        if len(streams) > 1:
            torch.cuda.set_device(home)
            events = [s.record_event() for s in streams]
            for s in streams:
                for ev in events:
                    s.wait_event(ev)
        elif self.groups[0][0].index != home:
            torch.cuda.set_device(home)

    def launch(self, l0, n_lines, step, refresh, replace):
        """One launch on every device: lines l0, l0 + step, ... (n_lines),
        after refreshing line ``refresh`` (-1: none; the per-line schedule
        only)."""
        self._launch(self._streams(), l0, n_lines, step, refresh, replace)

    def run(self, rev, replace):
        """One directional sweep over every line of the slabs."""
        L = self.L
        l0, step = (L - 1, -1) if rev else (0, 1)
        streams = self._streams()
        if not self.layout.per_line:
            self._launch(streams, l0, L, step, -1, replace)
            return
        prev = -1
        for s in range(L):
            i = l0 + s * step
            self._launch(streams, i, 1, step, prev, replace)
            prev = i
        self._launch(streams, l0, 0, step, prev, replace)


def slab_sweep(blocks, models, fixeds, axis, rev, replace, geometries,
               neighbours=None, packed=None):
    """One directional sweep over the slabs of a decomposed grid: K5 on
    CUDA slabs (updated in place and returned), the plain twin
    ``sweep.slab_sweep`` on CPU slabs (new slabs returned).  ``packed``:
    the slabs' ``pack_model``, when the caller keeps them."""
    if not blocks[0].is_cuda:
        return sweep.slab_sweep(blocks, models, fixeds, axis, rev, replace,
                                geometries, neighbours)
    packed = packed or [pack_model(m) for m in models]
    SlabSweep(blocks, fixeds, packed, axis, geometries,
              neighbours).run(rev, replace)
    return blocks
