"""Public facade: class ALI_FMM, the entry point users call.

Counterpart of ``alifmm_tpu/api.py``, method for method: ``__init__``
validation, ``update`` / ``update_parallel`` / ``update_i``,
``find_all_TTF_rays(_parallel)``, ``ray_path``, ``add_materials``,
``generate_group_vel`` / ``generate_phase_vel``, ``plot_group`` /
``plot_phase``.  Every travel-time field is solved by the line-sweep solver
(``solver.solve_ttf``, all sources in one batch) and all source-receiver
pairs are traced as one batch (``rays.trace_rays``).  The "parallel"
methods accept ``n_threads`` / ``low_mem`` for compatibility; the device
batch replaces the process pool.

``device=None`` builds every model on the CUDA card and raises on a host
without one; ``device="cpu"`` runs the plain PyTorch twins on the CPU.

``ttf_mode`` selects the ray tracer's fields: ``"interp"`` (the default)
solves the receiver fields on the model grid and samples them bilinearly;
``"grid"`` solves them on the grid refined ``subgrid_size`` times, as the
reference's travel_finer_grid does, and reads the nearest fine point.

``ray_opts["tracer"]`` picks the tracer: ``"search"`` (the default, the
plane search ``rays.trace_rays``), ``"descent"`` (``trace_rays_descent``)
or ``"auto"`` (``trace_rays_auto``: the descent, with the plane search for
the rays it cannot certify); the other keys are the tracer's knobs.

``grid_mesh`` (a ``parallel.Mesh``) solves every travel-time field with
the grid split over its axis ``grid_axis`` (one name for z slabs, two for
z and x blocks): ``parallel/shard.solve_ttf_halo``, whose final stage runs
on the slab sweep kernel K5 with halo exchanges between the slabs.

Under a ``torch.profiler`` trace (``utils/profiling.trace``) each public
solving method is the range ``alifmm.call.<method>``; inside it the model
builds (``alifmm.build``), the solve (``alifmm.solve``), the tracer
(``alifmm.rays``), each blocking copy of a result to the host
(``alifmm.facade.read``) and the float64 conversion with the scatter into
the outputs (``alifmm.facade.convert``).
"""

from __future__ import annotations

import inspect
import time
import warnings

import numpy as np
import torch

from . import grid as gridlib
from . import materials as mats
from . import rays as rayslib
from . import solver as solverlib
from .utils import progress as progresslib
from .utils import validate
from .utils.profiling import span, spanned

__all__ = ["ALI_FMM"]

# the tracers' arguments that are not knobs
_POSITIONAL = {"model", "rec_ttf", "ttf_index", "source_xy", "receiver_xy",
               "subgrid_size", "mode"}
_TRACERS = {"search": rayslib.trace_rays,
            "descent": rayslib.trace_rays_descent,
            "auto": rayslib.trace_rays_auto}


def _to_host(t):
    """A result tensor as a host array: on the card a blocking read, the
    range ``alifmm.facade.read``."""
    with span("facade.read"):
        return t.cpu().numpy()


class ALI_FMM:
    """Travel-time fields and ray tracing in anisotropic 2D media."""

    def __init__(
        self,
        veln,
        velpn,
        vel_map,
        scx,
        scz,
        group_vel=None,
        phase_vel=None,
        stif_den=None,
        dnx=1e-3,
        dtype=torch.float32,
        ttf_mode="interp",
        ray_opts=None,
        solve_opts=None,
        grid_mesh=None,
        grid_axis="gz",
        device=None,
    ):
        self.stif_den = stif_den
        if stif_den is not None:
            stif_arr = np.asarray(stif_den)
            if stif_arr.dtype != np.int64:
                raise TypeError(
                    "Stifness tensors and density array must have the type "
                    "np.int64. 32bit integers will not work correctly."
                )
            if stif_arr[0, 0, 0] > 1e9:
                print(
                    "Warning: Stifness tensors must be in MPa, due to 64 bit "
                    "integer limitations when solving the christoffel equation"
                )
        velpn = np.asarray(velpn)
        if not np.issubdtype(velpn.dtype, np.integer):
            raise TypeError("velpn must be a numpy array of integers")

        if group_vel is None:
            g, p = mats.default_tables()
            self.velocity_dat = g
            self.phase_vel = p
        else:
            self.velocity_dat = np.asarray(group_vel)
            self.phase_vel = np.asarray(phase_vel)

        self.veln = np.asarray(veln)
        self.velpn = velpn
        self.vel_map = np.asarray(vel_map)
        self.dnx = dnx
        self.dnz = dnx  # dnz is forced equal
        self.nnx = self.veln.shape[1]
        self.nnz = self.veln.shape[0]
        self.ttn = np.zeros(self.veln.shape)
        self.scx = np.asarray(scx, dtype=float)
        self.scz = np.asarray(scz, dtype=float)
        self.gox = 0
        self.goz = 0
        self.isx = np.round((self.scx - self.gox) / self.dnx)
        self.isz = np.round((self.scz - self.goz) / self.dnz)
        self.ntr = 0
        self.nsrc = len(self.scx)

        # heap bookkeeping of the reference, kept for attribute parity (the
        # solver is sweep-based and has no heap)
        snb = 0.5
        self.nsts = np.zeros((self.nnx, self.nnz), dtype=int)
        self.maxbt = round(snb * self.nnx * self.nnz)
        self.btg = np.zeros((self.maxbt, 2), dtype=int)

        self.ray_paths_x = None
        self.ray_paths_y = None
        self.ray_len = None

        self._dtype = dtype
        self._device = gridlib.resolve_device(device)
        self._ttf_mode = ttf_mode
        # extra ray-tracer knobs: "tracer" picks the marcher, the rest are
        # trace_rays' keyword arguments (see _route_ray_opts)
        self._ray_opts = dict(ray_opts or {})
        # solver iteration budget: a solver.SolveConfig or a dict of its
        # fields; the default is the conservative budget
        if isinstance(solve_opts, solverlib.SolveConfig):
            self._cfg = solve_opts
        else:
            self._cfg = solverlib.SolveConfig(**dict(solve_opts or {}))
        # a parallel.Mesh: every field is solved by the halo path with the
        # grid split over ``grid_axis``; None solves on the model's device
        self._grid_mesh = grid_mesh
        self._grid_axis = grid_axis

    # ------------------------------------------------------------------ #
    # model assembly
    # ------------------------------------------------------------------ #
    def _make_model(self, veln, velpn, vel_map, stif_den):
        if vel_map is None:
            vel_map = np.ones(np.asarray(veln).shape)
        has_stif = stif_den is not None and np.any(np.asarray(stif_den))
        return gridlib.make_model(
            np.asarray(veln),
            np.asarray(velpn),
            np.asarray(vel_map),
            np.asarray(stif_den) if has_stif else None,
            self.velocity_dat,
            self.phase_vel,
            self.dnx,
            dtype=self._dtype,
            device=self._device,
        )

    def _solve_fields(self, model, scx, scz, subgrid_size, progress=None):
        """One batched travel-time solve, (n, Z, X): on the model's device,
        or the halo solve over ``grid_mesh``, gathered on its first
        device."""
        if self._grid_mesh is not None:
            from .parallel import shard

            return shard.solve_ttf_halo(
                model, scx, scz, self._grid_mesh, axis=self._grid_axis,
                subgrid_size=int(subgrid_size), cfg=self._cfg,
            ).to(model.device)
        return solverlib.solve_ttf(
            model, scx, scz, int(subgrid_size), self._cfg, progress=progress
        )

    # ------------------------------------------------------------------ #
    # travel-time fields
    # ------------------------------------------------------------------ #
    @spanned("call.update")
    def update(self, veln, velpn, vel_map=None, stif_den=None,
               subgrid_size=1, sources=None):
        """All-source travel-time fields, float64 numpy.  Sources with
        mask 0 return zeros."""
        model = self._make_model(veln, velpn, vel_map, stif_den)
        if sources is None:
            sources = np.ones(self.nsrc, dtype=int)
        sources = np.asarray(sources)
        sel = np.nonzero(sources == 1)[0]
        out_fields = self._solve_fields(
            model, self.scx[sel], self.scz[sel], subgrid_size,
            progress=progresslib.auto_bar(f"TTF solve ({len(sel)} sources)"),
        )
        out_fields = _to_host(out_fields)
        with span("facade.convert"):
            out_fields = out_fields.astype(np.float64)
            full = np.zeros((self.nsrc,) + out_fields.shape[1:])
            full[sel] = out_fields
        return full

    @spanned("call.update_parallel")
    def update_parallel(self, veln, velpn, vel_map=None, stif_den=None,
                        subgrid_size=1, sources=None, n_threads=2,
                        low_mem=False):
        """All-source fields; ``n_threads`` is accepted for compatibility.
        With ``low_mem=True`` each field is saved as ``temp_TTF_{i}.npy``
        and None is returned."""
        del n_threads
        fields = self.update(veln, velpn, vel_map, stif_den, subgrid_size,
                             sources)
        if low_mem:
            if sources is None:
                sources = np.ones(self.nsrc, dtype=int)
            for i in np.nonzero(np.asarray(sources) == 1)[0]:
                np.save(f"temp_TTF_{i}.npy", fields[i])
            return None
        return fields

    @spanned("call.update_i")
    def update_i(self, source_i, veln, velpn, vel_map, stif_den=None,
                 subgrid_size=1):
        """Single-source field, float64 numpy."""
        model = self._make_model(veln, velpn, vel_map, stif_den)
        out = self._solve_fields(
            model,
            self.scx[source_i : source_i + 1],
            self.scz[source_i : source_i + 1],
            subgrid_size,
        )
        out = _to_host(out)
        with span("facade.convert"):
            return out.astype(np.float64)[0]

    # ------------------------------------------------------------------ #
    # travel-time fields + rays
    # ------------------------------------------------------------------ #
    @staticmethod
    def _route_ray_opts(tracer, trace_fn, opts):
        """Filter the flat ``ray_opts`` knobs for the selected tracer.  For
        ``"auto"`` a knob goes into ``descent_kw`` and ``search_kw``,
        whichever of the two tracers accepts it, and explicit entries of
        those two win.  Knobs that only another tracer accepts are dropped
        with a warning; keys no tracer accepts raise TypeError."""

        def params(fn):
            return set(inspect.signature(fn).parameters) - _POSITIONAL

        d_params = params(rayslib.trace_rays_descent)
        s_params = params(rayslib.trace_rays)
        a_params = params(rayslib.trace_rays_auto)
        unknown = [k for k in opts if k not in d_params | s_params | a_params]
        if unknown:
            raise TypeError(f"unknown ray_opts key(s): {unknown}")

        if tracer == "auto":
            routed = {k: v for k, v in opts.items() if k in a_params}
            descent_kw = dict(routed.pop("descent_kw", None) or {})
            search_kw = dict(routed.pop("search_kw", None) or {})
            dropped = []
            for k, v in opts.items():
                if k in a_params:
                    continue
                if k in d_params:
                    descent_kw.setdefault(k, v)
                if k in s_params:
                    search_kw.setdefault(k, v)
                if k not in d_params | s_params:
                    dropped.append(k)
            if dropped:
                warnings.warn(
                    f"ray_opts {dropped} not accepted by tracer='auto'; "
                    "dropped", stacklevel=3,
                )
            routed["descent_kw"] = descent_kw
            routed["search_kw"] = search_kw
            return routed

        accepted = params(trace_fn)
        dropped = [k for k in opts if k not in accepted]
        if dropped:
            warnings.warn(
                f"ray_opts {dropped} not accepted by tracer='{tracer}'; "
                "dropped", stacklevel=3,
            )
        return {k: v for k, v in opts.items() if k in accepted}

    def _solve_rays(self, veln, velpn, vel_map, stif_den, subgrid_size,
                    trans_pairs, save_rays):
        # tracer="search" (default) is the plane-search march; flat knobs
        # are routed to the selected tracer before anything is solved
        opts = dict(self._ray_opts)
        tracer = opts.pop("tracer", "search")
        trace_fn = _TRACERS[tracer]
        opts = self._route_ray_opts(tracer, trace_fn, opts)

        model = self._make_model(veln, velpn, vel_map, stif_den)
        s = int(subgrid_size)
        n_trans = len(self.isx)

        if trans_pairs is None:
            # default: upper triangle, one ray per pair
            trans_pairs = np.triu(np.ones((n_trans, n_trans)), k=1)
        trans_pairs = np.asarray(trans_pairs)
        rec_idx = np.nonzero(trans_pairs.sum(axis=0) > 0)[0]

        # receiver travel-time fields, batched on the device
        ttf_bar = progresslib.auto_bar(
            f"TTF solve ({len(rec_idx)} receivers)"
        )
        ttfs = self._solve_fields(
            model, self.scx[rec_idx], self.scz[rec_idx],
            s if self._ttf_mode == "grid" else 1, progress=ttf_bar,
        )
        rec_pos = {j: k for k, j in enumerate(rec_idx)}

        pair_i, pair_j = np.nonzero(trans_pairs == 1)
        keep = pair_i != pair_j  # a transducer does not pair with itself
        pair_i, pair_j = pair_i[keep], pair_j[keep]
        new_tx = s * self.isx
        new_ty = s * self.isz
        src_xy = np.stack([new_tx[pair_i], new_ty[pair_i]], axis=1)
        rec_xy = np.stack([new_tx[pair_j], new_ty[pair_j]], axis=1)
        ttf_index = np.array([rec_pos[j] for j in pair_j], dtype=np.int64)

        # single batched trace; the bar completes in one tick with the
        # wall time as postfix
        ray_bar = progresslib.progress_bar(
            len(pair_i), f"rays ({len(pair_i)} pairs)"
        )
        _t0 = time.perf_counter()
        with span("rays"):
            rx, ry, lens, times = trace_fn(
                model, ttfs, ttf_index, src_xy, rec_xy, s,
                mode=self._ttf_mode, **opts,
            )
        # the copies to the host wait for the device
        rx, ry, lens, times = (_to_host(t) for t in (rx, ry, lens, times))
        ray_bar.set_postfix_str(f"{time.perf_counter() - _t0:.2f}s")
        ray_bar.update(len(pair_i))
        ray_bar.close()

        with span("facade.convert"):
            rx, ry = rx.astype(np.float64), ry.astype(np.float64)
            times_mat = np.zeros((n_trans, n_trans))
            times_mat[pair_i, pair_j] = times.astype(np.float64)
            if save_rays:
                P = rx.shape[1]
                self.ray_paths_x = np.zeros((n_trans, n_trans, P))
                self.ray_paths_y = np.zeros((n_trans, n_trans, P))
                self.ray_len = np.zeros((n_trans, n_trans), dtype=int)
                # coordinates back on the model grid
                self.ray_paths_x[pair_i, pair_j] = rx / s
                self.ray_paths_y[pair_i, pair_j] = ry / s
                self.ray_len[pair_i, pair_j] = lens
        return times_mat

    @spanned("call.find_all_TTF_rays")
    def find_all_TTF_rays(self, veln, velpn, vel_map=None, subgrid_size=9,
                          trans_pairs=None, stif_den=None, save_rays=True):
        """Travel-time fields and rays for all transducer pairs.  Returns
        the (n, n) travel-time matrix; paths via ``ray_path``."""
        return self._solve_rays(
            veln, velpn, vel_map, stif_den, subgrid_size, trans_pairs,
            save_rays,
        )

    @spanned("call.find_all_TTF_rays_parallel")
    def find_all_TTF_rays_parallel(self, veln, velpn, vel_map=None,
                                   subgrid_size=9, trans_pairs=None,
                                   stif_den=None, n_threads=2, low_mem=False,
                                   save_rays=True):
        """Fields and rays with the reference's parallel signature; device
        batching replaces the process pool, and the results are those of
        ``find_all_TTF_rays``."""
        if n_threads == 1:
            raise Exception(
                "n_threads must be greater than 1 for parallel computation"
            )
        del low_mem
        model = self._make_model(veln, velpn, vel_map, stif_den)
        min_vel, max_vel = validate.min_max_vel(model)
        if min_vel < 1000:
            warnings.warn(
                f"Minimum velocity of {float(min_vel)} m/s is low: check "
                "model velocities"
            )
        if max_vel > 15000:
            warnings.warn(
                f"Maximum velocity of {float(max_vel)} m/s is high: check "
                "model velocities"
            )
        return self._solve_rays(
            veln, velpn, vel_map, stif_den, subgrid_size, trans_pairs,
            save_rays,
        )

    def ray_path(self, i, j):
        """Trimmed (ray_x, ray_y) of pair (i, j) on the model grid."""
        if self.ray_paths_x is None or self.ray_len is None:
            print("Ray paths have not been calculated")
            return None, None
        n = int(self.ray_len[i, j])
        if n == 0:
            print("Ray path has not been calculated for this pair")
            return None, None
        return self.ray_paths_x[i, j, :n], self.ray_paths_y[i, j, :n]

    # ------------------------------------------------------------------ #
    # materials
    # ------------------------------------------------------------------ #
    def generate_group_vel(self, c_22, c_23, c_33, c_44, density, plot=True):
        """361-entry group-velocity curve from stiffness (Pa) and density."""
        curve = mats.generate_group_vel_curve(c_22, c_23, c_33, c_44, density)
        if plot:
            self._plot_polar(curve, "Group Velocity")
        return curve

    def generate_phase_vel(self, c_22, c_23, c_33, c_44, density, plot=True):
        """361-entry phase-velocity curve."""
        curve = mats.generate_phase_vel_curve(c_22, c_23, c_33, c_44, density)
        if plot:
            self._plot_polar(curve, "Phase Velocity")
        return curve

    def add_materials(self, materials, keep_materials=False):
        """Build or extend the velocity tables from material rows."""
        g, p, ids = mats.build_tables(
            materials, self.velocity_dat, self.phase_vel, keep_materials
        )
        if keep_materials:
            if len(ids) == 1:
                print("material id of new material is " + str(ids[0]))
            else:
                print(
                    "material id's of new materials are "
                    + str(ids[0]) + " - " + str(ids[-1])
                )
        self.velocity_dat = g
        self.phase_vel = p

    # ------------------------------------------------------------------ #
    # plotting
    # ------------------------------------------------------------------ #
    @staticmethod
    def _plot_polar(curve, title):
        import matplotlib.pyplot as plt

        plt.polar(np.pi / 180 * np.arange(0, 361), curve)
        plt.title(title)
        plt.show()

    def plot_group(self, material_index=1):
        """Polar plot of a table material's group-velocity curve."""
        import matplotlib.pyplot as plt

        plt.polar(
            np.pi / 180 * self.velocity_dat[:, 0],
            self.velocity_dat[:, material_index],
        )
        plt.show()

    def plot_phase(self, material_index=1):
        """Polar plot of a table material's phase-velocity curve."""
        import matplotlib.pyplot as plt

        plt.polar(
            np.pi / 180 * self.velocity_dat[:, 0],
            self.phase_vel[:, material_index],
        )
        plt.show()
