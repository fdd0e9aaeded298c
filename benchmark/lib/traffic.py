"""The one generator that reads every traffic mix.

A mix is a JSON file, ``benchmark/traffic/<mix>.json``, of parameters:

- ``method``: the ``ALI_FMM`` method each call makes
  (``find_all_TTF_rays_parallel`` or ``update``);
- ``subgrid_size``: the call's ``subgrid_size``, or null for the
  configuration's;
- ``trans_pairs``: whether the call passes the array's pair matrix;
- ``turn_max_deg``, ``cycle_seed``: the inversion chain's cycle.  From the
  configuration's weld (``weld_seed``), the cycle turns each of the 9
  orientation domains once, in an order and by integer steps in
  [-turn_max_deg, turn_max_deg] (never 0) drawn from ``cycle_seed``, then
  turns them back in the same order: 18 maps, each differing from the one
  before it in one domain.

The calls form a closed loop of one client: the window sends the next
call when the last one has returned, walking the cycle from a point that
``--seed`` draws.  Every seed so sends the same maps, in another order,
and a window of some tens of calls does the same work whatever the seed.
"""

from __future__ import annotations

import numpy as np

from . import weld

__all__ = ["Traffic", "seed_rng", "cycle"]


def seed_rng(seed: int, stream: int):
    """A numpy generator of ``stream`` for any whole-number seed."""
    return np.random.default_rng([int(seed) % 2 ** 64, stream])


def cycle(angles, turn_max: int, cycle_seed: int):
    """The chain's 18 domain-angle tables (3, 3), starting at ``angles``:
    each domain turned once, then each turned back."""
    rng = np.random.default_rng(cycle_seed)
    n = angles.size
    order = rng.permutation(n)
    steps = rng.integers(1, turn_max + 1, size=n) * rng.choice([-1, 1], n)
    out, cur = [angles.copy()], angles.copy()
    for sign in (1, -1):
        for d, st in zip(order, steps):
            cur = cur.copy()
            cur.reshape(-1)[d] = (cur.reshape(-1)[d] + sign * st) % 180
            out.append(cur)
    return out[:-1]


class Traffic:
    """The calls of one run of a cell: ``first()`` the configuration's
    weld (the warm-up's), ``next()`` the chain's next weld, ``call(fm,
    w)`` makes the call."""

    def __init__(self, mix: dict, cfg: dict, seed: int):
        self.mix, self.cfg = mix, cfg
        self.base = weld.weld_maps(cfg["weld_seed"], cfg)
        self.sx, self.sy, self.pairs = weld.transducers(cfg)
        self.cycle = cycle(self.base.angles, int(mix["turn_max_deg"]),
                           int(mix["cycle_seed"]))
        self._k = int(seed_rng(seed, 1).integers(len(self.cycle)))
        s = mix.get("subgrid_size")
        self.subgrid = int(cfg["subgrid_size"] if s is None else s)

    def first(self):
        return self.base

    def next(self):
        self._k = (self._k + 1) % len(self.cycle)
        return self.base.turned(self.cycle[self._k])

    def call(self, fm, w):
        kw = dict(subgrid_size=self.subgrid, stif_den=w.stif)
        if self.mix.get("trans_pairs"):
            kw["trans_pairs"] = self.pairs
        if self.mix["method"] == "find_all_TTF_rays_parallel":
            kw["n_threads"] = 2
        return getattr(fm, self.mix["method"])(w.veln, w.velpn, w.vel_map,
                                                **kw)
