"""facade_copy_s (s a call): the facade's blocking copies of its results
to the host (fields, ray paths, lengths and times), the program's ranges
``alifmm.facade.read``."""

from benchmark.lib import program


def read(run):
    return program.seconds(run, "alifmm.facade.read")
