"""One run of one cell: set-up, the measured window, the traced window's
per-layer metrics, and the comparison that decides ``correct``.

Everything a cell is made of is found by name from ``BENCHMARK.json``:
the configuration's file, ``benchmark/traffic/<mix>.json`` (read by
``lib/traffic.py``), ``benchmark/metrics/<metric>.py`` (each a
``read(run)``) and ``benchmark/limits/<cell>.json`` (each number the
check compares, with its limit).
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import spans, traffic, yardstick

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
# modules that may not be loaded in a process that prints a result,
# compared by their whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "alifmm_tpu")
# calls of a window whose fields the check judges: a sample drawn from the
# seed, every call of the window as likely as any other
FIELD_CALLS = 3

__all__ = ["Cell", "run", "default_tables", "forbidden_modules"]


def default_tables():
    """The velocity tables the facade is given: column 0 the angle, column
    1 an isotropic unit-velocity material (the facade's own default)."""
    tab = np.ones((361, 2))
    tab[:, 0] = np.arange(361)
    return tab, tab.copy()


def forbidden_modules():
    """The forbidden top-level names present in ``sys.modules``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _load_json(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic
    mix, limits and metrics."""

    def __init__(self, name: str, root: str = ROOT):
        spec = _load_json(root, "BENCHMARK.json")
        work = {w["name"]: w for w in spec["workloads"]}
        if name not in work:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.work = work[name]
        conf = {c["name"]: c for c in spec["configs"]}[self.work["config"]]
        self.cfg = _load_json(root, conf["file"])
        self.mix = _load_json(root, "benchmark", "traffic",
                              self.work["traffic"] + ".json")
        self.limits = _load_json(root, "benchmark", "limits", name + ".json")

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in spec["end_to_end"] if mine(m)]
        self.per_layer = [m for m in spec["per_layer"] if mine(m)]

    @property
    def rays(self):
        return self.mix["method"] == "find_all_TTF_rays_parallel"


def _reader(name: str):
    path = os.path.join(BENCH, "metrics", name + ".py")
    mod_name = "bench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class TracedRun:
    """What a per-layer metric's reader reads: the traced calls' spans and
    counters (``calls``), the device trace's events, the traced window."""

    def __init__(self, calls, events):
        self.calls, self.events = calls, events
        xs = [e for e in events if "ts" in e and e.get("ph") == "X"]
        self.t0_us = min((float(e["ts"]) for e in xs), default=0.0)
        self.t1_us = max((float(e["ts"]) + float(e.get("dur", 0))
                          for e in xs), default=0.0)

    def mean(self, key, span=True):
        vals = [(c["spans"].get(key) if span else c.get(key))
                for c in self.calls]
        vals = [v for v in vals if v is not None]
        return float(np.mean(vals)) if vals else None


def _now():
    return time.perf_counter()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class FieldSample:
    """A sample of ``FIELD_CALLS`` of a window's calls, drawn from the seed
    as the calls come (reservoir sampling: once the window has closed,
    every call has been as likely to be in it as any other): each kept
    call's weld and fields, the fields on the host, so that what is kept
    adds nothing to the card's memory."""

    def __init__(self, seed: int):
        self.rng = traffic.seed_rng(seed, 4)
        self.seen = 0
        self.items = []

    def offer(self, w, fields):
        k = self.seen
        self.seen += 1
        slot = k if k < FIELD_CALLS else int(self.rng.integers(k + 1))
        if slot >= FIELD_CALLS:
            return
        item = (w, torch.as_tensor(fields).cpu())
        if slot < len(self.items):
            self.items[slot] = item
        else:
            self.items.append(item)


def _window(cell, fm, gen, rec, seconds, device, kept, sample):
    """Calls back to back while less than ``seconds`` have passed; every
    call started completes.  Every call's rays are appended to ``kept``,
    and its fields offered to ``sample``.  Returns (calls, failed, window
    seconds)."""
    n, failed = 0, 0
    t_start = _now()
    while _now() - t_start < seconds:
        w = gen.next()
        rec.begin_call()
        t0 = _now()
        try:
            out = gen.call(fm, w)
        except Exception as exc:  # a failed call counts against correct
            print(f"call {n} failed: {exc!r}", file=sys.stderr)
            failed += 1
            out = None
        rec.end_call(_now() - t0)
        n += 1
        if out is not None:
            if cell.rays:
                kept.append((w, out, fm.ray_paths_x, fm.ray_paths_y,
                             fm.ray_len))
            sample.offer(w, rec.fields if cell.rays else out)
        rec.fields = None  # frees the call's fields before the next call
    t_end = _now()
    _sync(device)
    return n, failed, t_end - t_start


def _trace_window(cell, fm, gen, rec, seconds, device, kept, sample):
    tmp = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            res = _window(cell, fm, gen, rec, seconds, device, kept,
                          sample)
            _sync(device)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res, events


def idle_gaps(events, n: int = 10):
    """The device's idle time inside the traced window, by the innermost
    ``bench.`` span of the host that the gap's midpoint falls in
    ("host, between calls" where none): [[name, seconds], ...], the ``n``
    largest."""
    dev = yardstick.device_events(events)
    if not dev:
        return []
    marks = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and str(e.get("name", "")).startswith("bench."))
    busy = yardstick.busy_intervals(dev)
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    t0 = min(float(e["ts"]) for e in xs)
    t1 = max(float(e["ts"]) + float(e.get("dur", 0)) for e in xs)
    gaps, prev = [], t0
    for a, b in busy + [[t1, t1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    by = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inner = [m for m in marks if m[0] <= mid <= m[1]]
        name = (min(inner, key=lambda m: m[1] - m[0])[2] if inner
                else "host, between calls")
        by[name] = by.get(name, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def _map_key(w):
    """A digest of a weld's inputs to the model: calls that send the same
    map share one reference model."""
    h = hashlib.sha1()
    for a in (w.veln, w.velpn, w.vel_map, w.stif):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def check(cell, gen, sample, kept, seed, device, round_to=None):
    """The numbers the reference reads (see ``reference/check.py``) for the
    fields of the calls in ``sample`` (a ``FieldSample``) and every call's
    rays (``kept``): those the cell's limits name, each the worst over the
    calls.  ``round_to`` (the control): a lower precision every field and
    ray time passes through before it is judged.  The reference builds its
    model once for each map the calls sent."""
    from ..reference import check as chk
    from ..reference.model import RefModel

    cfg = cell.cfg
    tab_g, tab_p = default_tables()
    dnx = cfg["dnx"]
    grid_fields = cfg["ttf_mode"] == "grid" or not cell.rays
    s_field = gen.subgrid if grid_fields else 1
    sx, sy, pairs = gen.sx, gen.sy, gen.pairs
    solved = (np.nonzero(pairs.sum(axis=0) > 0)[0] if cell.rays
              else np.arange(len(sx)))
    rows, cols = chk.source_points(sx[solved], sy[solved], dnx, s_field)
    models = {}

    def ref_model(w, **kw):
        key = (_map_key(w), tuple(sorted(kw.items())))
        if key not in models:
            models[key] = RefModel(w.veln, w.velpn, w.vel_map, w.stif, tab_g,
                                   tab_p, dnx, device, **kw)
        return models[key]

    k = cfg.get("residual_sources")
    elems = (np.arange(len(solved)) if k is None else
             np.sort(traffic.seed_rng(seed, 3).choice(
                 len(solved), size=min(k, len(solved)), replace=False)))
    half = cfg["near_source_half"][str(s_field)]
    nums = dict(bad_points=0, residual_p50=0.0, residual_p90=0.0)
    for w, fields in sample.items:
        fields = fields.to(device)
        if round_to is not None:
            fields = fields.to(round_to).to(fields.dtype)
        bad, p50, p90 = chk.field_numbers(ref_model(w, scale=s_field),
                                          fields, rows, cols, elems, half)
        nums["bad_points"] += bad
        nums["residual_p50"] = max(nums["residual_p50"], p50)
        nums["residual_p90"] = max(nums["residual_p90"], p90)
        del fields
    models.clear()
    if cell.rays:
        isx = np.round(sx / dnx).astype(np.int64)
        isz = np.round(sy / dnx).astype(np.int64)
        pi, pj = np.nonzero(pairs == 1)
        keep = pi != pj
        pi, pj = pi[keep], pj[keep]
        src = np.stack([isx[pi], isz[pi]], 1).astype(np.float64)
        dst = np.stack([isx[pj], isz[pj]], 1).astype(np.float64)
        gap, off = 0.0, 0.0
        for wk, times_mat, px, py, plen in kept:
            if round_to is not None:
                times_mat = torch.as_tensor(times_mat).to(round_to).double()
                times_mat = times_mat.numpy()
            g, o = chk.ray_numbers(ref_model(wk, planes=False),
                                   times_mat[pi, pj], px[pi, pj],
                                   py[pi, pj], plen[pi, pj], src, dst,
                                   cfg["ray_time_cross"])
            gap, off = max(gap, g), max(off, o)
        nums.update(ray_time_gap=gap, path_end_cells=off)
    return {name: nums[name] for name in cell.limits}


def judge(nums, limits):
    """Whether every number is finite and within its limit."""
    ok = True
    for name, v in nums.items():
        lim = limits[name]
        ok &= bool(math.isfinite(v) and v <= lim)
    return ok


def _device_for(cell, device):
    """The device a run uses: the card, which must be there with as many
    devices as the cell asks for, unless a test names one."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark runs on the card "
                         "only, and has no CPU fallback")
    need = int(cell.work["chips"])
    if torch.cuda.device_count() < need:
        raise SystemExit(f"{cell.name} needs {need} CUDA devices, "
                         f"{torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


class Session:
    """A cell's facade and spans in one process: ``setup`` builds the
    facade for a seed's first weld and makes the warm-up call; ``measure``
    runs a window of one seed's chain and judges it.  The benchmark's run
    makes one of each; ``benchmark/control.py`` measures many seeds after
    one set-up."""

    def __init__(self, workload, trace, device=None, root=ROOT):
        self.cell = Cell(workload, root)
        self.device = _device_for(self.cell, device)
        if root not in sys.path:
            sys.path.insert(0, root)
        import alifmm_tpu_torch

        alifmm_tpu_torch.tqdm_disable = True
        self.trace = bool(trace)
        tab_p = default_tables()[1]
        const = [m for m in range(1, tab_p.shape[1])
                 if np.ptp(tab_p[:181, m]) == 0.0]
        self.rec = spans.Recorder(const, has_stif=True)
        self.fm = None

    def setup(self, seed):
        from alifmm_tpu_torch import ALI_FMM

        cfg = self.cell.cfg
        gen = traffic.Traffic(self.cell.mix, cfg, seed)
        tab_g, tab_p = default_tables()
        w0 = gen.first()
        self.fm = ALI_FMM(
            w0.veln, w0.velpn, w0.vel_map, gen.sx, gen.sy, group_vel=tab_g,
            phase_vel=tab_p, stif_den=w0.stif, dnx=cfg["dnx"],
            dtype=getattr(torch, cfg["dtype"]), ttf_mode=cfg["ttf_mode"],
            ray_opts=cfg["ray_opts"], solve_opts=cfg["solve_opts"],
            device=self.device)
        self.rec.install(False)
        try:
            gen.call(self.fm, w0)
        finally:
            self.rec.uninstall()
        _sync(self.device)
        return gen

    def measure(self, gen, seed, seconds, control=False):
        """A window of ``gen``'s calls, then the check.  Returns a dict:
        calls, failed, window_s, peak bytes, the trace's events, the
        numbers compared (``nums``) and with ``control`` the control's."""
        dev = self.device
        kept, sample = [], FieldSample(seed)
        self.rec.calls = []
        self.rec.install(self.trace)
        try:
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            if self.trace:
                (n, failed, window_s), events = _trace_window(
                    self.cell, self.fm, gen, self.rec, seconds, dev, kept,
                    sample)
            else:
                n, failed, window_s = _window(
                    self.cell, self.fm, gen, self.rec, seconds, dev, kept,
                    sample)
                events = []
            peak = (torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else 0)
        finally:
            self.rec.uninstall()
        self.rec.fields = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out = dict(n=n, failed=failed, window_s=window_s, peak=peak,
                   events=events, calls=self.rec.calls, nums={})
        if sample.items:
            out["nums"] = check(self.cell, gen, sample, kept, seed, dev)
            if control:
                out["control"] = check(self.cell, gen, sample, kept, seed,
                                       dev, round_to=torch.bfloat16)
        out["correct"] = bool(sample.items and failed == 0
                              and judge(out["nums"], self.cell.limits))
        return out


def run(workload, seed, seconds, trace, t_proc0, device=None,
        root=ROOT, control=False):
    """One run of ``workload``: the result line, a dict, with the
    numbers compared under ``checks``; raises ``SystemExit`` with a
    message where no run can be made.  ``device`` None means the card,
    which must be there (a test passes "cpu").  ``control``: also judge
    the reference's control, every field and ray time in bfloat16
    (``control_checks``, ``control_correct``); the benchmark's own runs
    do not."""
    ses = Session(workload, trace, device, root)
    gen = ses.setup(seed)
    setup_s = _now() - t_proc0
    m = ses.measure(gen, seed, seconds, control)
    ses.fm = None
    cell, device = ses.cell, ses.device
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
               count=1, memory_peak_bytes=int(m["peak"]))
    metrics, breakdown = {}, None
    if not trace:
        vals = dict(inspection_s=m["window_s"] / max(m["n"], 1),
                    setup_s=setup_s, peak_mem_gb=m["peak"] / 1e9)
        for e in cell.end_to_end:
            metrics[e["name"]] = dict(value=vals[e["name"]], unit=e["unit"])
    else:
        traced = TracedRun(m["calls"], m["events"])
        for e in cell.per_layer:
            v = _reader(e["name"])(traced)
            if v is not None:
                metrics[e["name"]] = dict(value=v, unit=e["unit"])
        bs = yardstick.busy_share(m["events"], traced.t0_us, traced.t1_us)
        if bs is not None:
            dev["busy_s"], dev["window_s"] = bs
        breakdown = dict(device_ops=yardstick.top_device_ops(m["events"]),
                         idle_gaps=idle_gaps(m["events"]))
    if device.type == "cuda":
        dev["power_limit"] = _power_limit()
    result = dict(correct=m["correct"], attempted=m["n"], failed=m["failed"],
                  metrics=metrics, device=dev)
    if breakdown is not None:
        result["breakdown"] = breakdown
    if "control" in m:
        result["control_correct"] = judge(m["control"], cell.limits)
        result["control_checks"] = m["control"]
    result["checks"] = {k: dict(value=v, limit=cell.limits[k])
                        for k, v in m["nums"].items()}
    # last, once the check, the readers and the breakdown have loaded all
    # they load: a run in whose process JAX or the JAX package is found
    # prints no result
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    return result
