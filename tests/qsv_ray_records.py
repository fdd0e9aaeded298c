"""The shear welds' rays that the port's tracers do not land, traced by the
JAX package on the CPU.  Not a test: a record, run by hand.

``chip_smoke.py`` (phase 11c) writes them with their receiver fields to
``smoke_out/qsv_rays_not_arrived.npz``: the rays the plane search with
the weld's knobs finishes early, and the rays the auto tracer with its
defaults does not land (phase 14c likewise for the qSV weld with an FD
envelope, phase 15c for the qSH weld: the file names its table mode).
This script traces the same rays through the same fields (float32) on
the same model with the JAX package: the first with ``trace_rays`` and
the weld's knobs, the second with ``trace_rays_descent``, ``trace_rays``
and ``trace_rays_auto`` at their defaults, and prints each beside the
port's lengths, reasons and times.

Usage:  python tests/qsv_ray_records.py [path to the .npz]"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from alifmm_tpu import grid as jgrid  # noqa: E402
from alifmm_tpu import rays as jrays  # noqa: E402
from alifmm_tpu_torch import weld_data  # noqa: E402


def main(path):
    d = np.load(path)
    g, p = chip_smoke.qsv_tables(mode=str(d["mode"]) if "mode" in d
                                 else "qSV")
    veln, velpn, vel_map = chip_smoke.qsv_weld_arrays()
    model = jgrid.make_model(veln, velpn, vel_map, None, g, p, weld_data.DNX,
                             dtype=jnp.float32)
    where = {int(r): k for k, r in enumerate(d["rays"])}
    field = {int(f): k for k, f in enumerate(d["field_ids"])}
    fields = jnp.asarray(d["fields"])
    s = weld_data.SUBGRID

    def inputs(rays):
        k = np.array([where[int(r)] for r in rays])
        tidx = np.array([field[int(t)] for t in d["tidx"][k]])
        return (model, fields, jnp.asarray(tidx), jnp.asarray(d["src"][k]),
                jnp.asarray(d["rec"][k]), s)

    if len(d["search_rays"]):
        rays = d["search_rays"]
        out = jrays.trace_rays(*inputs(rays), mode="interp",
                               return_reason=True, **chip_smoke.RAY_OPTS)
        print(f"plane search, the weld's knobs, rays {rays.tolist()}:")
        print(f"  JAX:  vertices {np.asarray(out[2]).tolist()} reasons "
              f"{np.asarray(out[4]).tolist()} times "
              f"{np.asarray(out[3]).tolist()}")
        print(f"  port: vertices {d['search_len'].tolist()} reasons "
              f"{d['search_reason'].tolist()} times "
              f"{d['search_time'].tolist()}")
    if len(d["auto_rays"]):
        rays = d["auto_rays"]
        args = inputs(rays)
        dn = jrays.trace_rays_descent(*args, mode="interp",
                                      return_reason=True)
        sr = jrays.trace_rays(*args, mode="interp", return_reason=True)
        au = jrays.trace_rays_auto(*args, mode="interp")
        print(f"defaults, rays {rays.tolist()}:")
        print(f"  JAX descent: vertices {np.asarray(dn[2]).tolist()} "
              f"reasons {np.asarray(dn[4]).tolist()}")
        print(f"  JAX search:  vertices {np.asarray(sr[2]).tolist()} "
              f"reasons {np.asarray(sr[4]).tolist()} times "
              f"{np.asarray(sr[3]).tolist()}")
        print(f"  JAX auto:    vertices {np.asarray(au[2]).tolist()} times "
              f"{np.asarray(au[3]).tolist()}")
        print(f"  port auto:   times {d['auto_time'].tolist()}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, chip_smoke.QSV_RAYS_FILE))
