"""k1_launches (launches a call): K1's launches, one a pass, each
followed by one host read in the pass driver
(``ops/cuda_sweep.solve_fixpoint``), from ``cuda_sweep.LAUNCHES``."""


def read(run):
    return run.mean("k1_launches", span=False)
