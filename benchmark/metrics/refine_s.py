"""refine_s (s a call): the fine path's refinement of the whole model
(``grid.refine_model``: the nearest-neighbour refinement and the fallback
slowness planes rebuilt on the refined grid), the program's range
``alifmm.refine``, summed over a call's solves; None in a cell that solves
on the model grid, or with a program that opens no such range."""

from benchmark.lib import program


def read(run):
    return program.seconds(run, "alifmm.refine")
