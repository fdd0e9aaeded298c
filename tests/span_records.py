"""Records of the program's ranges (``alifmm.<layer>.<step>``) in the
benchmark's cells, on the card.  Not a test: a CUDA device is needed.

    python tests/span_records.py weld_qp.chain,weld_qp.tfm SEED[,SEED] \\
        [--seconds 51] [--cost-seconds 20 --cost-pairs 2] [--out DIR]

For each cell (one seed each; the next two seeds for the traced and the
cost windows):

1. ``sync``: one call under ``torch.cuda.set_sync_debug_mode("warn")``,
   with a CPU profiler running so that the ranges open; each warning of a
   synchronising operation is placed by a marker range and listed with
   the innermost ``alifmm.`` range that holds it and the line of the
   port that made it.  A blocking read to the host must lie in a range
   whose name ends in ``.read``; a blocking copy to the card from
   pageable memory warns too (PyTorch synchronises the stream after it).
2. ``traced``: a traced run of the cell (``harness.run`` with ``--trace
   1``: its result line) and, from the same trace, the ranges a call by
   name (count and seconds), the ``alifmm.pass`` ranges against the run's
   K1 launches, the ``alifmm.build`` range against the benchmark's
   ``model_build_s``, the card's idle seconds a call by innermost range,
   and the share of the idle inside ``alifmm.call.*`` that no child range
   names.
3. ``cost`` (with ``--cost-pairs``): traced windows with the spans
   forced off and on, alternating in one process, and the microseconds
   of a span under a running profiler and with none.

A summary line per cell goes to standard output, the whole record to
``DIR/span_records_<cell>.json`` with ``--out``.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from alifmm_tpu_torch.utils import profiling  # noqa: E402
from benchmark.lib import harness, program  # noqa: E402

MARK = "sync_warning."


def _port_frame(stack):
    mine = [f for f in stack if os.path.join(ROOT, "alifmm_tpu_torch")
            in f.filename]
    return mine[-1] if mine else None


def sync_check(cell, seed):
    ses = harness.Session(cell, trace=False)
    gen = ses.setup(seed)
    w = gen.next()
    torch.cuda.synchronize()
    hits = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        with torch.profiler.record_function(MARK + str(len(hits))):
            pass
        f = _port_frame(traceback.extract_stack()[:-1])
        hits.append(dict(
            where=(f"{os.path.relpath(f.filename, ROOT)}:{f.lineno}"
                   if f else None),
            code=f.line.strip() if f else None))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                gen.call(ses.fm, w)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    events = [dict(ph="X", cat="user_annotation", name=e.name,
                   ts=e.time_range.start, dur=e.time_range.elapsed_us())
              for e in prof.events()
              if e.name.startswith((program.PREFIX, MARK))]
    marks = {e["name"]: e["ts"] for e in events
             if e["name"].startswith(MARK)}
    held = program.holders(program.ranges(events))
    for k, h in enumerate(hits):
        names = held(marks[MARK + str(k)])
        h["innermost"] = names[0] if names else None
        h["in_read"] = any(n.endswith(".read") for n in names)
    ses.fm = None
    torch.cuda.empty_cache()
    return hits


def traced(cell, seed, seconds):
    """``harness.run`` with tracing, keeping the window's events and
    calls for what the result line does not carry."""
    box = {}
    trace_window, measure = harness._trace_window, harness.Session.measure

    def keep_events(*a, **kw):
        res, box["events"] = trace_window(*a, **kw)
        return res, box["events"]

    def keep_calls(self, *a, **kw):
        m = measure(self, *a, **kw)
        box["calls"] = m["calls"]
        return m

    harness._trace_window, harness.Session.measure = keep_events, keep_calls
    try:
        result = harness.run(cell, seed, seconds, 1, time.perf_counter())
    finally:
        harness._trace_window, harness.Session.measure = trace_window, measure
    run = harness.TracedRun(box["calls"], box["events"])
    rs = program.ranges(run.events)
    n = len(run.calls)
    count, secs = {}, {}
    for a, b, name in rs:
        count[name] = count.get(name, 0) + 1 / n
        secs[name] = secs.get(name, 0.0) + (b - a) / 1e6 / n
    held = program.holders(rs)
    in_call = own = 0.0
    for a, b in program.gaps(run):
        names = held(0.5 * (a + b))
        if any(x.startswith(program.PREFIX + "call.") for x in names):
            in_call += (b - a) / 1e6 / n
            if names[0].startswith(program.PREFIX + "call."):
                own += (b - a) / 1e6 / n
    model_build = run.mean("make_model")
    return result, dict(
        calls=n, call_s=float(np.mean([c["call_s"] for c in run.calls])),
        ranges_a_call=len(rs) / n, count=count, seconds=secs,
        k1_launches=run.mean("k1_launches", span=False),
        build_over_model_build=secs.get("alifmm.build", 0.0) / model_build,
        idle_in_calls_s=in_call, idle_call_alone_s=own,
        idle_call_alone_share=own / in_call if in_call else None,
        idle_by_range=program.idle_by_range(run))


def cost(cell, seed, seconds, pairs):
    ses = harness.Session(cell, trace=True)
    gen = ses.setup(seed)
    real = profiling._profiling
    windows = []
    for i in range(pairs):
        for mode in (("off", "on") if i % 2 == 0 else ("on", "off")):
            profiling._profiling = real if mode == "on" else (lambda: False)
            ses.rec.calls = []
            ses.rec.install(True)
            try:
                (calls, _, window_s), events = harness._trace_window(
                    ses.cell, ses.fm, gen, ses.rec, seconds, ses.device, [],
                    harness.FieldSample(seed))
            finally:
                ses.rec.uninstall()
                profiling._profiling = real
            windows.append(dict(spans=mode, calls=calls,
                                call_s=window_s / calls,
                                ranges_a_call=len(program.ranges(events))
                                / calls))
            del events
    n = 20000
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        t = time.perf_counter()
        for _ in range(n):
            with profiling.span("cost"):
                pass
        on_us = (time.perf_counter() - t) / n * 1e6
    t = time.perf_counter()
    for _ in range(n):
        with profiling.span("cost"):
            pass
    off_us = (time.perf_counter() - t) / n * 1e6
    ses.fm = None
    torch.cuda.empty_cache()
    return dict(windows=windows, span_us_profiling=on_us,
                span_us_not_profiling=off_us)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("cells")
    p.add_argument("seeds")
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--cost-seconds", type=float, default=20.0)
    p.add_argument("--cost-pairs", type=int, default=0)
    p.add_argument("--out")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("span_records.py needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    for cell, seed in zip(a.cells.split(","),
                          (int(s) for s in a.seeds.split(","))):
        rec = dict(cell=cell, seed=seed, card=card)
        rec["sync"] = sync_check(cell, seed)
        rec["result"], rec["traced"] = traced(cell, seed + 1, a.seconds)
        if a.cost_pairs:
            rec["cost"] = cost(cell, seed + 2, a.cost_seconds, a.cost_pairs)
        if a.out:
            os.makedirs(a.out, exist_ok=True)
            with open(os.path.join(a.out, f"span_records_{cell}.json"),
                      "w") as fh:
                json.dump(rec, fh, indent=1)
        sync = {}
        for h in rec["sync"]:
            key = f"{h['where']} [{h['innermost']}] {h['code']}"
            sync[key] = sync.get(key, 0) + 1
        print(json.dumps(dict(
            cell=cell, seed=seed, card=card, correct=rec["result"]["correct"],
            sync=sync, metrics={k: v["value"]
                     for k, v in rec["result"]["metrics"].items()},
            traced={k: v for k, v in rec["traced"].items()
                    if k not in ("count", "seconds")},
            cost=rec.get("cost"))), flush=True)


if __name__ == "__main__":
    main()
