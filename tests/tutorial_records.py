"""The tutorial's gradient model in the JAX package, against the analytic
first arrival.  Not a test: a record, run by hand on the CPU.

``examples/tutorial.ipynb``'s first model (v = 3000 + 10 m/s a row,
dnx = 1e-3, transducers at 40/100/160 cells on the top edge, scaled with
n) through ``alifmm_tpu.ALI_FMM(...).update`` with the facade's default
budgets, in float64 and float32, against chip_smoke.py's analytic time
(``gradient_time``: t = arccosh(1 + g^2 r^2 / (2 v0 v)) / g in the linear
gradient v = v0 + g z from a source at depth 0): for each source, the
largest and the mean relative error over the points more than 5 cells
from it.  chip_smoke.py's phase 13a holds the port on the card to these
numbers at n = 201.

Usage:  python tests/tutorial_records.py [n]   (n = 201 by default: about
7 minutes on 8 cores, 211 s in float64 and 216 s in float32; the
``seconds`` of each type are printed)."""

import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "1"
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from alifmm_tpu import ALI_FMM  # noqa: E402
from chip_smoke import (TUTORIAL_COLS, TUTORIAL_DNX as DNX,  # noqa: E402
                        TUTORIAL_DV, TUTORIAL_N, TUTORIAL_NEAR,
                        TUTORIAL_V0, gradient_time)


def gradient_model(n):
    """The notebook's first model at size n, its transducers scaled from
    the columns of TUTORIAL_N cells."""
    veln = np.zeros((n, n))
    velpn = np.ones((n, n), dtype=int)
    vel_map = TUTORIAL_V0 + TUTORIAL_DV * np.arange(n)[:, None] * np.ones(
        (1, n))
    cols = np.round(np.array(TUTORIAL_COLS) * (n - 1) / (TUTORIAL_N - 1))
    return veln, velpn, vel_map, DNX * cols, np.zeros(3)


def analytic_errors(fields, scx, n):
    """(max, mean) relative error of each source's field against the
    analytic gradient time, over points more than TUTORIAL_NEAR cells
    away."""
    t, r2 = gradient_time(scx, n)
    far = r2 > (TUTORIAL_NEAR * DNX) ** 2
    rels = (np.abs(fields[k] - t[k])[far[k]] / t[k][far[k]]
            for k in range(len(scx)))
    return [(float(r.max()), float(r.mean())) for r in rels]


def main(n=TUTORIAL_N):
    veln, velpn, vel_map, scx, scz = gradient_model(n)
    rec = dict(n=n)
    for name, dt in (("float64", jnp.float64), ("float32", jnp.float32)):
        t0 = time.perf_counter()
        fm = ALI_FMM(veln, velpn, vel_map, scx, scz, dnx=DNX, dtype=dt)
        fields = fm.update(veln, velpn, vel_map)
        err = analytic_errors(fields, scx, n)
        rec[name] = dict(max=[e[0] for e in err], mean=[e[1] for e in err],
                         seconds=time.perf_counter() - t0)
        print(f"{name}: {json.dumps(rec[name])}", flush=True)
    print(json.dumps(rec))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else TUTORIAL_N)
