"""Named ranges on the profiler's clock, and a device trace of a region.

``span(name)`` marks a piece of the port's work as the range
``alifmm.<name>`` of any running ``torch.profiler`` trace, on the same
timeline as the card's kernels and copies; ``spanned(name)`` puts one
around every call of a function.  With no profiler running a span is one
check and a shared no-op context: it creates no ``RecordFunction`` and
touches no tensor.  A span records host time only: it never synchronises
the device and never reorders work, so what the card did during a span is
read off the trace.  The names are ``alifmm.<layer>.<step>``; every
blocking read from the card to the host is a range of its own whose name
ends in ``.read``.

``trace`` writes a ``torch.profiler`` trace of a region (CPU and, where
the card is present, CUDA activities) as a Chrome trace for Perfetto or
``chrome://tracing``; the ``alifmm.`` ranges lie in it beside the kernels.
"""

from __future__ import annotations

import contextlib
import functools
import os
import tempfile

import torch

__all__ = ["span", "spanned", "trace", "PREFIX", "TRACE_FILE"]

# the prefix of every range the port opens
PREFIX = "alifmm."
# the Chrome trace's name inside trace()'s log_dir
TRACE_FILE = "trace.json"

_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that is the range ``alifmm.<name>`` while a profiler
    runs, and otherwise the one shared no-op context."""
    if not _profiling():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def spanned(name: str):
    """Decorator: ``span(name)`` around every call, checked at the call
    (a decorator is applied when no profiler runs)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return wrapped
    return deco


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
