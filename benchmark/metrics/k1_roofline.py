"""k1_roofline (%): K1's share of its roofline.  The least time the
call's K1 launches could take on an H100, each the larger of its fp32
operations over 67 TFLOP/s and its bytes over 3.35 TB/s
(``lib/yardstick.pass_bound_s``: 4 sweeps x the points each launch
updates x each point's operations by its material path), over K1's
device time in the trace (kernels named ``sweep_pass_kernel``).  Nothing
to read without K1 in the trace."""

from benchmark.lib import spans, yardstick


def read(run):
    k1 = sum(b - a for a, b, name in yardstick.device_events(run.events)
             if spans.K1_KERNEL in name) / 1e6
    bound = sum(c.get("k1_bound_s", 0.0) for c in run.calls)
    if k1 <= 0 or bound <= 0:
        return None
    return 100.0 * bound / k1
