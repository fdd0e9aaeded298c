"""patch_stages_s (s a call): the solver's refined near-source patch
stages (``solver._stage_first``/``_stage_next``), from the seconds
``solve_ttf`` reports to its ``progress`` callback."""


def read(run):
    return run.mean("patch_stages")
