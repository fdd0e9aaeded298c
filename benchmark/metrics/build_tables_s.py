"""build_tables_s (s a call): the model build's ray curve tables
(``grid._ray_curve_tables``) and their column summaries
(``materials.column_info``), host numpy, the program's range
``alifmm.build.tables``, summed over a call's builds."""

from benchmark.lib import program


def read(run):
    return program.seconds(run, "alifmm.build.tables")
