"""final_stage_s (s a call): the solver's full-grid stage
(``solver._stage_final``), from the seconds ``solve_ttf`` reports to its
``progress`` callback."""


def read(run):
    return run.mean("final_stage")
