"""Spans and counters around the port's layers, from the benchmark's own
files: wrappers put on the module attributes through which the facade
calls each layer, and taken off again.

``Recorder.install(trace)`` always keeps the last solve's fields (the
window offers them to the check's sample of calls, then drops them); with
``trace`` it also records, per call,
the seconds of ``grid.make_model``, ``solver.solve_ttf`` (with its stage
seconds from the solver's ``progress`` callback) and the ray tracer, the
model builds, K1's launches (``cuda_sweep.LAUNCHES``) and each K1 launch's
bound (``lib/yardstick.pass_bound_s``), and marks those layers and the
solver's stages as ``torch.profiler.record_function`` ranges
(``bench.<layer>``), which the idle gaps of the device trace are named
by.  Traced spans synchronise the device at their end, so that a span
holds its layer's device work.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from . import yardstick

__all__ = ["Recorder", "K1_KERNEL"]

# K1's kernel in the device trace (csrc/sweep.cu, sweep_pass_kernel)
K1_KERNEL = "sweep_pass_kernel"


class Recorder:
    """Per-call spans and counters of one run (see the module doc)."""

    def __init__(self, const_cols, has_stif: bool):
        self.const_cols = tuple(const_cols)
        self.has_stif = has_stif
        self.fields = None
        self.calls = []
        self._cur = None
        self._undo = []
        self._ops_cache = {}
        self.trace = False

    # -- wrapping ---------------------------------------------------------
    def _put(self, owner, name, new, key=None):
        if key is None:
            old = getattr(owner, name)
            setattr(owner, name, new(old))
            self._undo.append(lambda: setattr(owner, name, old))
        else:
            old = owner[key]
            owner[key] = new(old)
            self._undo.append(lambda: owner.__setitem__(key, old))

    def install(self, trace: bool):
        from alifmm_tpu_torch import api, grid, solver
        from alifmm_tpu_torch.ops import cuda_sweep

        self.trace = trace
        self._put(solver, "solve_ttf", self._solve)
        if not trace:
            return
        self._put(grid, "make_model", lambda f: self._span("make_model", f))
        for name in ("_stage_first", "_stage_next", "_stage_final"):
            self._put(solver, name,
                      lambda f, n=name: self._mark("stage" + n[6:], f))
        for key in list(api._TRACERS):
            self._put(api._TRACERS, None, lambda f: self._span("rays", f),
                      key=key)
        self._put(cuda_sweep, "sweep_pass", self._k1)

    def uninstall(self):
        while self._undo:
            self._undo.pop()()

    # -- calls ------------------------------------------------------------
    def begin_call(self):
        from alifmm_tpu_torch.ops import cuda_sweep

        self.fields = None
        if self.trace:
            self._cur = dict(spans={}, builds=0, k1_bound_s=0.0,
                             launches0=cuda_sweep.LAUNCHES)

    def end_call(self, seconds: float):
        from alifmm_tpu_torch.ops import cuda_sweep

        if self.trace:
            c = self._cur
            c["call_s"] = seconds
            c["k1_launches"] = cuda_sweep.LAUNCHES - c.pop("launches0")
            self.calls.append(c)
            self._cur = None

    def _add(self, name, seconds):
        if self._cur is not None:
            s = self._cur["spans"]
            s[name] = s.get(name, 0.0) + seconds

    # -- wrappers ---------------------------------------------------------
    def _span(self, name, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            with torch.profiler.record_function("bench." + name):
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                self._add(name, time.perf_counter() - t0)
                if name == "make_model" and self._cur is not None:
                    self._cur["builds"] += 1
            return out
        return wrapped

    @staticmethod
    def _mark(name, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            with torch.profiler.record_function("bench." + name):
                return fn(*args, **kw)
        return wrapped

    def _solve(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            if not self.trace:
                out = fn(*args, **kw)
                self.fields = out
                return out

            def progress(stage, total, name, seconds):
                self._add("final_stage" if stage >= total else
                          "patch_stages", seconds)

            kw["progress"] = progress
            with torch.profiler.record_function("bench.solve_ttf"):
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                self._add("solve_ttf", time.perf_counter() - t0)
            self.fields = out
            return out
        return wrapped

    def _source_ops(self, model, fixed):
        """Per source, the summed point operations of the points that are
        not fixed (host floats), for a stage's model and fixed mask."""
        key = (id(fixed), id(model.velpn))
        hit = self._ops_cache.get(key)
        if hit is not None and hit[0] is fixed:
            return hit[1]
        per = yardstick.point_ops(model.velpn.to(torch.int64), self.has_stif,
                                  self.const_cols)
        free = ~fixed.to(torch.bool)
        ops = (per * free).sum(dim=(-2, -1)).double().cpu().numpy()
        self._ops_cache = {key: (fixed, ops)}
        return ops

    def _k1(self, fn):
        from alifmm_tpu_torch.ops import sweep

        @functools.wraps(fn)
        def wrapped(tt, model, fixed, replace, active=None, packed=None,
                    form=sweep.DEFAULT):
            if (self._cur is not None and tt.is_cuda
                    and form == sweep.DEFAULT):
                B, Z, X = tt.shape
                ops = self._source_ops(model, fixed)
                act = (np.ones(B, bool) if active is None
                       else np.broadcast_to(np.asarray(active, bool), (B,)))
                free_ops = float(ops[act].sum())
                Bm = B if model.velpn.dim() == 3 else 1
                self._cur["k1_bound_s"] += yardstick.pass_bound_s(
                    free_ops, B, Z, X, Bm, tt.element_size())
            return fn(tt, model, fixed, replace, active, packed, form)
        return wrapped
