"""facade_host_s (s a call): the facade's own host time, a call's span
less its model builds (``grid.make_model``), its solve
(``solver.solve_ttf``) and its tracer: pair building,
``validate.min_max_vel``, the copies to the host and the float64
conversion."""


def read(run):
    vals = [c["call_s"] - sum(c["spans"].get(k, 0.0)
                              for k in ("make_model", "solve_ttf", "rays"))
            for c in run.calls]
    return sum(vals) / len(vals) if vals else None
