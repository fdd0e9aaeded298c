"""Progress reporting for long batched solves.

All sources are solved as one batch, so the natural progress unit is the
telescoping stage (4 per solve) plus the ray batch, reported through
``solver.solve_ttf``'s ``progress`` callback.  Set
``alifmm_tpu_torch.tqdm_disable = True`` to silence all bars (they are
also silent when tqdm is not installed).
"""

from __future__ import annotations

import sys

__all__ = ["progress_bar", "stage_reporter", "auto_bar"]


def _disabled() -> bool:
    import alifmm_tpu_torch

    return bool(getattr(alifmm_tpu_torch, "tqdm_disable", False))


def progress_bar(total: int, desc: str):
    """A tqdm bar if available (and not disabled), else a no-op shim.
    The returned object supports ``update(n)``, ``set_postfix_str(s)`` and
    ``close()``."""
    if not _disabled():
        try:
            from tqdm import tqdm

            return tqdm(total=total, desc=desc, file=sys.stderr,
                        leave=True)
        except Exception:  # pragma: no cover - tqdm missing
            pass

    class _Noop:
        def update(self, n=1):
            pass

        def set_postfix_str(self, s):
            pass

        def close(self):
            pass

    return _Noop()


def stage_reporter(bar):
    """Adapt a ``progress_bar`` to ``solve_ttf``'s ``progress`` callback:
    one tick a stage, the stage's name and seconds as the postfix."""

    def cb(stage, total, name, seconds):
        bar.set_postfix_str(f"{name} {seconds:.2f}s")
        bar.update(1)

    return cb


def auto_bar(desc: str):
    """``solve_ttf`` ``progress`` callback that opens a bar sized from the
    first callback's ``total`` and closes itself on the last stage.
    Returns None (no callback, so no synchronise per stage) when bars are
    disabled."""
    if _disabled():
        return None
    holder = {}

    def cb(stage, total, name, seconds):
        bar = holder.get("bar")
        if bar is None:
            bar = holder["bar"] = progress_bar(total, desc)
        bar.set_postfix_str(f"{name} {seconds:.2f}s")
        bar.update(1)
        if stage >= total:
            bar.close()

    return cb
