"""device_idle (share): the share of the traced window in which no
kernel, copy or fill ran on the card (``lib/yardstick.busy_share``)."""

from benchmark.lib import yardstick


def read(run):
    bs = yardstick.busy_share(run.events, run.t0_us, run.t1_us)
    if bs is None or bs[1] <= 0:
        return None
    return 1.0 - bs[0] / bs[1]
