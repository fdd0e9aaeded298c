"""PyTorch port, the program's ranges (``utils/profiling.span``): under a
profiler the facade's calls open the ``alifmm.`` ranges in the nesting
the layers have, one ``alifmm.pass`` a sweep pass; with no profiler a
span opens nothing.

CPU only, on a 6 x 8 weld with one element on the top row and one on the
bottom row, a 3x patch stage and one-pass budgets, so that the plain
twin's solves take about a second.  The profiler records the user-scope
ranges only: every operation of the twin would otherwise be an event too
(millions of them, and tens of seconds to collect)."""

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch._C._profiler import RecordScope

import alifmm_tpu_torch
from alifmm_tpu_torch import solver, weld_data
from alifmm_tpu_torch.ops import sweep
from alifmm_tpu_torch.utils import profiling
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SHAPE = (6, 8)
BUDGET = dict(patch_max_passes=1, final_max_passes=1, polish_passes=1,
              sweep_block=1, patch_block=1)


@pytest.fixture(scope="module")
def weld():
    veln, velpn, vel_map, stif = weld_data.weld_model_arrays(2, SHAPE)
    sx, sy, _ = weld_data.transducers(SHAPE, weld_data.DNX, 1, 1)
    return dict(veln=veln, velpn=velpn, vel_map=vel_map,
                stif_den=np.round(stif).astype(np.int64), sx=sx, sy=sy)


@pytest.fixture(scope="module")
def facade(weld):
    mp = pytest.MonkeyPatch()
    mp.setattr(solver, "_COARSE_STAGES", ((1, 3),))
    mp.setattr(solver, "_COARSE_SEED_SIDE", 2)
    mp.setattr(alifmm_tpu_torch, "tqdm_disable", True)
    fm = alifmm_tpu_torch.ALI_FMM(
        weld["veln"], weld["velpn"], weld["vel_map"], weld["sx"], weld["sy"],
        stif_den=weld["stif_den"], dnx=weld_data.DNX, dtype=torch.float64,
        solve_opts=BUDGET, ray_opts=dict(max_steps=8), device="cpu")
    yield fm
    mp.undo()


def _calls(fm, weld):
    maps = (weld["veln"], weld["velpn"], weld["vel_map"])
    fm.update(*maps, stif_den=weld["stif_den"])
    fm.find_all_TTF_rays_parallel(*maps, stif_den=weld["stif_den"],
                                  subgrid_size=3)


@pytest.fixture(scope="module")
def traced(facade, weld):
    """The ranges of one ``update`` and one ``find_all_TTF_rays_parallel``
    under a profiler of the CPU activity, as (name, ancestors' names),
    and the plain passes the two calls ran."""
    mp = pytest.MonkeyPatch()
    enable = autograd_profiler._enable_profiler
    mp.setattr(autograd_profiler, "_enable_profiler",
               lambda cfg, acts: enable(cfg, acts, {RecordScope.USER_SCOPE}))
    passes = sweep.CALLS
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _calls(facade, weld)
    finally:
        mp.undo()
    passes = sweep.CALLS - passes
    out = []
    for ev in prof.events():
        up, p = [], ev.cpu_parent
        while p is not None:
            up.append(p.name)
            p = p.cpu_parent
        out.append((ev.name, up))
    return out, passes


def _under(traced, name):
    return [up for n, up in traced if n == name]


def test_ranges_nest_as_the_layers(traced):
    rs, _ = traced
    assert all(n.startswith(profiling.PREFIX) for n, _ in rs)
    calls = {n for n, up in rs if not up}
    assert calls == {"alifmm.call.update",
                     "alifmm.call.find_all_TTF_rays_parallel"}
    builds = _under(rs, "alifmm.build")
    # one build in update, two in find_all_TTF_rays_parallel
    assert sorted(up[0] for up in builds) == [
        "alifmm.call.find_all_TTF_rays_parallel"] * 2 + [
        "alifmm.call.update"]
    for part in ("planes", "tables", "upload"):
        ups = _under(rs, "alifmm.build." + part)
        assert len(ups) == 3 and all(up[0] == "alifmm.build" for up in ups)
    solves = _under(rs, "alifmm.solve")
    assert sorted(up[0] for up in solves) == [
        "alifmm.call.find_all_TTF_rays_parallel", "alifmm.call.update"]
    for stage in ("first", "final"):
        ups = _under(rs, "alifmm.stage." + stage)
        assert len(ups) == 2 and all(up[0] == "alifmm.solve" for up in ups)
    for up in _under(rs, "alifmm.pass"):
        assert up[0] == "alifmm.fixpoint"
        assert up[1].startswith("alifmm.stage.") and up[2] == "alifmm.solve"
    assert [up[0] for up in _under(rs, "alifmm.validate.read")] == [
        "alifmm.validate"] * 2
    assert _under(rs, "alifmm.rays") == [
        ["alifmm.call.find_all_TTF_rays_parallel"]]
    # the fields of update; the paths, lengths and times of the rays
    assert len(_under(rs, "alifmm.facade.read")) == 5
    assert sorted(up[0] for up in _under(rs, "alifmm.facade.convert")) == [
        "alifmm.call.find_all_TTF_rays_parallel", "alifmm.call.update"]


def test_a_pass_range_per_pass(traced):
    rs, passes = traced
    # patch and final stage of two solves, each 1 + 1 polish pass
    assert passes == 8
    assert len(_under(rs, "alifmm.pass")) == passes


def test_no_record_function_without_a_profiler(facade, weld, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a span opened a RecordFunction")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    off = profiling.span("solve")
    assert off is profiling.span("pass")
    fm = facade
    fields = fm.update(weld["veln"], weld["velpn"], weld["vel_map"],
                       stif_den=weld["stif_den"])
    assert fields.shape == (2,) + SHAPE and np.isfinite(fields).all()
