"""stage_idle_s (s a call): the card's idle seconds in the solver's
stages outside the passes, in gaps whose midpoint an ``alifmm.stage.*``
range holds and no ``alifmm.pass`` range does: each stage's set-up
(patch models, seed or injection, packing) and the fixpoint's host logic
between passes."""

from benchmark.lib import program


def read(run):
    return program.idle_s(run, program.STAGE, program.PASS)
