"""host_reads (reads a call): the program's blocking reads from the card
to the host, counted as its ranges whose name ends in ``.read``
(``alifmm.pass.read``, ``alifmm.facade.read`` and the others)."""

from benchmark.lib import program


def read(run):
    return program.reads(run)
