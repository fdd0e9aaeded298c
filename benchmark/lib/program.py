"""The program's own ranges in a traced window.

The port marks its layers as ``torch.profiler`` ranges named
``alifmm.<layer>.<step>`` (``alifmm_tpu_torch/utils/profiling.span``), on
the clock of the card's kernels and copies; every blocking read from the
card to the host is a range whose name ends in ``.read``.  The readers
here take those ranges from the harness's traced window
(``TracedRun.events``), per call of the window.  A program that opens no
such range gives nothing to read: each reader then returns None.

The card's idle time is cut into gaps as ``harness.idle_gaps`` cuts it
(the traced window less the merged device events), and a gap belongs to
the ranges that hold its midpoint.
"""

from __future__ import annotations

import bisect

from . import yardstick

__all__ = ["PREFIX", "ranges", "seconds", "reads", "gaps", "holders",
           "idle_s", "idle_by_range"]

PREFIX = "alifmm."
PASS = PREFIX + "pass"
STAGE = PREFIX + "stage."


def ranges(events):
    """(start_us, end_us, name) of the program's ranges on the host,
    sorted by start, the outer of two that start together first."""
    return sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                    e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and str(e.get("name", "")).startswith(PREFIX)),
                  key=lambda r: (r[0], -r[1]))


def _per_call(run, total):
    return total / len(run.calls) if run.calls else None


def seconds(run, name: str):
    """Seconds a call in the ranges called ``name``; None where the trace
    holds none."""
    rs = [b - a for a, b, n in ranges(run.events) if n == name]
    return _per_call(run, sum(rs) / 1e6) if rs else None


def reads(run):
    """Blocking reads to the host a call: the ranges whose name ends in
    ``.read``; None where the trace holds no program range."""
    rs = ranges(run.events)
    if not rs:
        return None
    return _per_call(run, float(sum(n.endswith(".read") for _, _, n in rs)))


def gaps(run):
    """The card's idle gaps (start_us, end_us) inside the traced window."""
    busy = yardstick.busy_intervals(yardstick.device_events(run.events))
    out, prev = [], run.t0_us
    for a, b in busy + [[run.t1_us, run.t1_us]]:
        if a > prev:
            out.append((prev, a))
        prev = max(prev, b)
    return out


def holders(rs):
    """A function of a time: the names of the ranges of ``rs`` (nested,
    from one thread) that hold it, innermost first."""
    starts = [a for a, _, _ in rs]
    parent, stack = [], []
    for i, (a, b, _) in enumerate(rs):
        while stack and not (rs[stack[-1]][0] <= a and b <= rs[stack[-1]][1]):
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)

    def held(t):
        out = []
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0:
            if rs[i][1] >= t:
                out.append(rs[i][2])
            i = parent[i]
        return out
    return held


def idle_s(run, inside, outside=None):
    """The card's idle seconds a call in gaps whose midpoint a range
    named ``inside`` holds (a name ending in ``.``: any range under that
    prefix) and no range named ``outside`` does; None where the trace
    holds no range ``inside`` names, or no device event."""
    rs = ranges(run.events)

    def named(n, key):
        return n.startswith(key) if key.endswith(".") else n == key

    if not any(named(n, inside) for _, _, n in rs):
        return None
    if not yardstick.device_events(run.events):
        return None
    held = holders(rs)
    total = 0.0
    for a, b in gaps(run):
        names = held(0.5 * (a + b))
        if any(named(n, inside) for n in names) and not (
                outside and any(named(n, outside) for n in names)):
            total += (b - a) / 1e6
    return _per_call(run, total)


def idle_by_range(run):
    """The card's idle seconds a call by the innermost program range that
    holds the gap's midpoint ("outside the program" where none):
    {name: seconds}."""
    rs = ranges(run.events)
    held = holders(rs)
    by = {}
    for a, b in gaps(run):
        names = held(0.5 * (a + b))
        key = names[0] if names else "outside the program"
        by[key] = by.get(key, 0.0) + (b - a) / 1e6
    n = max(len(run.calls), 1)
    return {k: v / n for k, v in sorted(by.items(), key=lambda kv: -kv[1])}
