"""The reader of ``refine_s`` (``metrics/refine_s.py``): the program's range
``alifmm.refine`` around ``grid.refine_model``, on the two calls of
``data/trace_program.json`` with a refinement added to each, on that trace
as it is (a cell on the model grid: nothing to read), and on a trace of
the port's own ``refine_model`` on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from _tiny import BENCH, load

from benchmark.lib import harness

DATA = load(BENCH, "tests", "data", "trace_program.json")
# two refinements over the trace's two calls, 40 and 60 us: 50 us a call
REFINES = [dict(ph="X", cat="user_annotation", name="alifmm.refine",
                ts=ts, dur=dur, pid=1, tid=1)
           for ts, dur in ((1320.0, 40.0), (2320.0, 60.0))]


def test_refine_s_reads_the_range():
    run = harness.TracedRun(DATA["calls"], DATA["traceEvents"] + REFINES)
    assert harness._reader("refine_s")(run) == pytest.approx(50e-6)


def test_refine_s_finds_nothing_on_the_model_grid():
    run = harness.TracedRun(DATA["calls"], DATA["traceEvents"])
    assert harness._reader("refine_s")(run) is None


def test_refine_s_reads_the_program(tmp_path):
    from alifmm_tpu_torch import grid

    Z, X = 4, 5
    model = grid.make_model(
        np.full((Z, X), 30.0), np.zeros((Z, X), np.int64), np.ones((Z, X)),
        np.broadcast_to(np.array([263000, 148000, 216000, 129000, 8100]),
                        (Z, X, 5)).copy(),
        None, None, 2e-4, dtype=torch.float32, device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fine = grid.refine_model(model, 3)
    assert fine.shape == (10, 13)
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    run = harness.TracedRun([dict(call_s=1.0, spans={})], events)
    assert harness._reader("refine_s")(run) > 0
