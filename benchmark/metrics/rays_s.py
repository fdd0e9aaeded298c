"""rays_s (s a call): the ray phase, the facade's tracer
(``rays.trace_rays``: K2, then K3), its device work included.  Nothing to
read in a cell whose calls trace no rays."""


def read(run):
    return run.mean("rays")
