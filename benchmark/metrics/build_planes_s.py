"""build_planes_s (s a call): the model build's fallback slowness planes
(``grid._np_fallback_slowness_planes``, host numpy), the program's range
``alifmm.build.planes``, summed over a call's builds."""

from benchmark.lib import program


def read(run):
    return program.seconds(run, "alifmm.build.planes")
