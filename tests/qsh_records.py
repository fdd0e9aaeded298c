"""Homogeneous qSH in the JAX package, against the closed-form first
arrival.  Not a test: a record, run by hand on the CPU.

chip_smoke.py's phase 15d model (``QSH_SHAPE`` 424 x 500, dnx
``QSH_DNX``, orientation 0, the qSH pair of ``generate_mode_curves(
*QSV_STIFF, c66=QSH_C66, mode="qSH")`` as table column 2, one source at
``QSH_SOURCE``) through ``alifmm_tpu.solver.solve_ttf`` with the full
stage schedule and ``SolveConfig.for_mode("qsh")``, in float64 and
float32, against ``qsh_homogeneous_time``: qSH is elliptical, so t =
sqrt((x / v0)^2 + (z / v90)^2) with v0 = sqrt(c66 / rho) along x and v90
= sqrt(c44 / rho) along z.  Prints the largest and the mean relative
error over every point but the source, the final stage's passes and the
seconds.  chip_smoke.py's phase 15d holds the port on the card to the
float64 numbers plus a float32 margin (``QSH_JAX_ERROR``,
``QSH_F32_MARGIN``).

Usage:  python tests/qsh_records.py   (the ``seconds`` of each type are
printed)."""

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

from alifmm_tpu import grid as jgrid  # noqa: E402
from alifmm_tpu import solver as jsolver  # noqa: E402
from chip_smoke import (QSH_DNX, QSH_SOURCE, QSH_SHAPE,  # noqa: E402
                        qsh_errors, qsh_homogeneous_arrays,
                        qsh_homogeneous_time, qsv_tables)


def main():
    g, p = qsv_tables(mode="qSH")
    want = qsh_homogeneous_time()
    sz, sx = QSH_SOURCE
    rec = dict(shape=list(QSH_SHAPE), dnx=QSH_DNX, source=list(QSH_SOURCE))
    for name, dt in (("float64", jnp.float64), ("float32", jnp.float32)):
        t0 = time.perf_counter()
        model = jgrid.make_model(*qsh_homogeneous_arrays(), None, g, p,
                                 QSH_DNX, dtype=dt)
        tt, info = jsolver.solve_ttf(
            model, jnp.asarray([sx * QSH_DNX], dt),
            jnp.asarray([sz * QSH_DNX], dt), 1,
            jsolver.SolveConfig.for_mode("qsh"), return_info=True)
        field = np.asarray(tt[0])
        mx, mean = qsh_errors(field, want)
        rec[name] = dict(max=mx, mean=mean, passes=int(info.passes),
                         converged=bool(info.converged),
                         finite=bool(np.isfinite(field).all()),
                         seconds=time.perf_counter() - t0)
        print(f"{name}: {json.dumps(rec[name])}", flush=True)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
