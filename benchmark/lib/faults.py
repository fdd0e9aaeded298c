"""Faults planted in the port underneath a run, to show that the check
that decides ``correct`` sees them.  Neither the benchmark's own runs nor
the port use them: ``benchmark/control.py`` and the CPU tests do.

- ``state_unchanged``: the solver's final stage returns the state it was
  given (the injected near-source patches, every other point unknown);
- ``half_batch``: the solver solves the first half of the sources, and the
  second half of the batch gets copies of their fields;
- ``answer_altered``: one answer is altered where it is produced: with
  rays, the first ray's time by 1 % as the tracer returns it; without, the
  first element's whole field by 5 % as the solver returns it.
"""

from __future__ import annotations

import contextlib
import functools

import torch

__all__ = ["FAULTS", "planted"]

FAULTS = ("state_unchanged", "half_batch", "answer_altered")


@contextlib.contextmanager
def planted(name: str, rays: bool):
    """The port with fault ``name`` planted, for the ``with`` block."""
    from alifmm_tpu_torch import api, solver

    undo = []

    def put(owner, attr, new, key=None):
        if key is None:
            old = getattr(owner, attr)
            setattr(owner, attr, functools.wraps(old)(new(old)))
            undo.append(lambda: setattr(owner, attr, old))
        else:
            old = owner[key]
            owner[key] = functools.wraps(old)(new(old))
            undo.append(lambda: owner.__setitem__(key, old))

    if name == "state_unchanged":
        def final(old):
            def f(model, prev_tt, prev_bz, prev_bx, cfg):
                return solver._final_inputs(model, prev_tt, prev_bz,
                                            prev_bx)[0], None
            return f
        put(solver, "_stage_final", final)
    elif name == "half_batch":
        def half(old):
            def f(model, scx, scz, *args, **kw):
                n = len(scx)
                h = (n + 1) // 2
                out = old(model, scx[:h], scz[:h], *args, **kw)
                return torch.cat([out, out[: n - h]])
            return f
        put(solver, "solve_ttf", half)
    elif name == "answer_altered" and rays:
        def alter_ray(old):
            def f(*args, **kw):
                rx, ry, lens, times = old(*args, **kw)
                times = times.clone()
                times[0] = times[0] * 1.01
                return rx, ry, lens, times
            return f
        put(api._TRACERS, None, alter_ray, key="search")
    elif name == "answer_altered":
        def alter_field(old):
            def f(*args, **kw):
                out = old(*args, **kw).clone()
                out[0] = out[0] * 1.05
                return out
            return f
        put(solver, "solve_ttf", alter_field)
    else:
        raise ValueError(f"no fault {name!r}: {FAULTS}")
    try:
        yield
    finally:
        while undo:
            undo.pop()()
