"""facade_convert_s (s a call): the facade's float64 conversion of the
copied results and their scatter into its outputs, the program's range
``alifmm.facade.convert``."""

from benchmark.lib import program


def read(run):
    return program.seconds(run, "alifmm.facade.convert")
