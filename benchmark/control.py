"""The readings that the limits of ``benchmark/limits/<cell>.json`` are set
from, on the card, at the cell's own size, in one process.

    python benchmark/control.py --workload <cell> --seeds 11,12,13 \\
        --seconds 5 [--faults state_unchanged,half_batch,answer_altered]

For each seed: a short window of the cell's own calls, then the numbers
the check compares for the program (the lower readings) and for the
control, the reference's bfloat16 in the program's place: every field and
ray time passed through bfloat16 before it is judged (the upper
readings).  With ``--faults``, each planted fault of ``lib/faults.py`` on
each seed; each must come out not correct.  One JSON line per reading.
The benchmark's own runs do not run this.
"""

import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark.lib import faults, harness, traffic  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--faults", default="")
    a = p.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",")]
    ses = harness.Session(a.workload, trace=0)
    ses.setup(seeds[0])
    print(json.dumps(dict(workload=a.workload,
                          setup_s=time.perf_counter() - T_PROC0)),
          flush=True)
    rays = ses.cell.rays
    for seed in seeds:
        gen = traffic.Traffic(ses.cell.mix, ses.cell.cfg, seed)
        m = ses.measure(gen, seed, a.seconds, control=True)
        print(json.dumps(dict(
            seed=seed, calls=m["n"], correct=m["correct"], nums=m["nums"],
            control=m["control"],
            control_correct=harness.judge(m["control"], ses.cell.limits))),
            flush=True)
        for name in filter(None, a.faults.split(",")):
            with faults.planted(name, rays):
                gen = traffic.Traffic(ses.cell.mix, ses.cell.cfg, seed)
                f = ses.measure(gen, seed, a.seconds)
            print(json.dumps(dict(seed=seed, fault=name, calls=f["n"],
                                  correct=f["correct"], nums=f["nums"])),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
