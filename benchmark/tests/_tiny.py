"""A checkout of a tiny weld cell for the CPU tests: the harness, traffic
mixes and readers of this benchmark with a 24 x 30 configuration, and the
solver cut to one 3x patch stage (the plain twins' cost on the CPU)."""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BENCH = os.path.join(ROOT, "benchmark")


def load(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def make_root(tmp, limits=None):
    """A checkout in ``tmp`` with cells ``tiny.chain`` and ``tiny.tfm`` on
    a 24 x 30 weld of three + three elements; ``limits`` (by cell) replace
    the limits of weld_qp's cells, which they start from."""
    os.makedirs(os.path.join(tmp, "benchmark", "configs"), exist_ok=True)
    os.makedirs(os.path.join(tmp, "benchmark", "limits"), exist_ok=True)
    shutil.copytree(os.path.join(BENCH, "traffic"),
                    os.path.join(tmp, "benchmark", "traffic"),
                    dirs_exist_ok=True)
    cfg = load(BENCH, "configs", "weld_qp.json")
    cfg.update(name="tiny", shape=[24, 30], n_trans=3, gap=6,
               near_source_half={"1": 2})
    with open(os.path.join(tmp, "benchmark", "configs", "tiny.json"),
              "w") as fh:
        json.dump(cfg, fh)
    spec = load(ROOT, "BENCHMARK.json")
    spec["configs"] = [dict(spec["configs"][0], name="tiny",
                            file="benchmark/configs/tiny.json")]
    spec["workloads"] = [
        dict(name="tiny.chain", config="tiny", traffic="chain", chips=1,
             why="CPU test"),
        dict(name="tiny.tfm", config="tiny", traffic="tfm", chips=1,
             why="CPU test")]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny.chain"]
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    for cell, src in (("tiny.chain", "weld_qp.chain"),
                      ("tiny.tfm", "weld_qp.tfm")):
        lim = load(BENCH, "limits", src + ".json")
        lim.update((limits or {}).get(cell, {}))
        with open(os.path.join(tmp, "benchmark", "limits", cell + ".json"),
                  "w") as fh:
            json.dump(lim, fh)
    return tmp


def cut_solver(monkeypatch):
    """One 3x patch stage with a seed side of 4 points."""
    from alifmm_tpu_torch import solver

    monkeypatch.setattr(solver, "_COARSE_STAGES", ((2, 3),))
    monkeypatch.setattr(solver, "_COARSE_SEED_SIDE", 4)


def run(root, cell, seed=2 ** 31 + 11, trace=0, control=False):
    import torch

    from benchmark.lib import harness

    with torch.inference_mode():
        return harness.run(cell, seed, 0.5, trace, time.perf_counter(),
                           device="cpu", root=root, control=control)
