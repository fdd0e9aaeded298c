"""build_upload_s (s a call): the model build's casts and copies to the
card (``grid.model_from_numpy``), the program's range
``alifmm.build.upload``, summed over a call's builds."""

from benchmark.lib import program


def read(run):
    return program.seconds(run, "alifmm.build.upload")
