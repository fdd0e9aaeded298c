"""Run one cell of the benchmark once, on the card it is started on.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cells, their configurations, traffic mixes, metrics and limits are
named in ``BENCHMARK.json`` at the root of the checkout.  With ``--trace
0`` the result carries the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics from a ``torch.profiler`` trace of the window.  The
last line of standard output is the result, one JSON object; the last
lines of standard error give each number the correctness check compared,
beside its limit.  Without a CUDA device, or with fewer than the cell
asks for, the run prints no result and exits with 2.
"""

import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark.lib import harness  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    try:
        result = harness.run(a.workload, a.seed, a.seconds, a.trace, T_PROC0)
    except SystemExit as exc:
        print(f"run.py: {exc}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
