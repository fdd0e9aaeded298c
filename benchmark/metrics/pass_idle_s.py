"""pass_idle_s (s a call): the card's idle seconds in the pass driver, in
gaps whose midpoint an ``alifmm.pass`` range holds (one K1 launch with
its two reads of delta and scale, ``ops/cuda_sweep.sweep_pass``)."""

from benchmark.lib import program


def read(run):
    return program.idle_s(run, program.PASS)
