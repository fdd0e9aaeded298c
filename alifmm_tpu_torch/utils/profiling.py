"""Timing and device-trace helpers.

Counterpart of ``alifmm_tpu/utils/profiling.py``: ``device_timer``, a wall
clock that waits for the device to finish what was collected inside it,
and ``trace``, a ``torch.profiler`` trace of a region (CPU and, where the
card is present, CUDA activities) written as a Chrome trace for Perfetto
or ``chrome://tracing``.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

__all__ = ["device_timer", "trace", "Timings", "TRACE_FILE"]

# the Chrome trace's name inside trace()'s log_dir
TRACE_FILE = "trace.json"


class Timings(dict):
    """Seconds by name, added up over ``device_timer`` regions."""

    def report(self):
        return "\n".join(f"{k}: {v:.4f}s" for k, v in self.items())


@contextlib.contextmanager
def device_timer(timings: Timings, name: str, *results):
    """Add the wall time of the region to ``timings[name]``.  Tensors
    passed here or to the yielded collector's ``collect`` must lie on one
    device, which is synchronised before the clock stops (no wait for CPU
    tensors); tensors on different devices raise ValueError."""
    holder = list(results)

    class _Collector:
        @staticmethod
        def collect(x):
            holder.append(x)
            return x

    t0 = time.perf_counter()
    yield _Collector
    devices = {t.device for t in holder if isinstance(t, torch.Tensor)}
    if len(devices) > 1:
        raise ValueError(f"device_timer collected tensors on "
                         f"{sorted(map(str, devices))}: one device only")
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """``torch.profiler`` trace around a region, written on exit as the
    Chrome trace ``TRACE_FILE`` in ``log_dir`` (by default a directory
    ``alifmm_trace`` in the temporary directory).  CUDA activities are
    recorded when a card is present.  Yields ``log_dir``."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "alifmm_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
