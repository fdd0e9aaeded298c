"""The frozen weld generator and the chain's step."""

import numpy as np
import pytest

from _tiny import BENCH, load

from benchmark.lib import traffic, weld

CFG = load(BENCH, "configs", "weld_qp.json")


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_generator_matches_the_port(seed):
    from alifmm_tpu_torch import weld_data

    w = weld.weld_maps(seed, CFG)
    veln, velpn, vel_map, stif = weld_data.weld_model_arrays(seed)
    np.testing.assert_array_equal(w.veln, veln)
    np.testing.assert_array_equal(w.velpn, velpn)
    np.testing.assert_array_equal(w.vel_map, vel_map)
    np.testing.assert_array_equal(w.stif, stif)
    sx, sy, pairs = weld.transducers(CFG)
    sx2, sy2, pairs2 = weld_data.transducers()
    np.testing.assert_array_equal(sx, sx2)
    np.testing.assert_array_equal(sy, sy2)
    np.testing.assert_array_equal(pairs, pairs2)


@pytest.mark.parametrize("mix", ["chain", "tfm"])
def test_chain_repeats_per_seed_and_keeps_to_its_step(mix):
    m = load(BENCH, "traffic", mix + ".json")
    seed = 2 ** 31 + 77
    a, b = traffic.Traffic(m, CFG, seed), traffic.Traffic(m, CFG, seed)
    np.testing.assert_array_equal(a.first().veln,
                                  weld.weld_maps(CFG["weld_seed"], CFG).veln)
    starts = {int(traffic.Traffic(m, CFG, s)._k) for s in range(40)}
    assert len(starts) > 1
    prev = a.next()
    b.next()
    seen = {prev.angles.tobytes()}
    for _ in range(40):
        wa, wb = a.next(), b.next()
        np.testing.assert_array_equal(wa.veln, wb.veln)
        turn = (wa.angles - prev.angles) % 180
        turn = np.minimum(turn, 180 - turn)
        assert (turn != 0).sum() <= 1
        assert turn.max() <= m["turn_max_deg"]
        assert ((0 <= wa.angles) & (wa.angles < 180)).all()
        # parent metal and materials never move
        np.testing.assert_array_equal(wa.velpn, prev.velpn)
        np.testing.assert_array_equal(wa.vel_map, prev.vel_map)
        np.testing.assert_array_equal(wa.veln[~wa.weld], 0)
        seen.add(wa.angles.tobytes())
        prev = wa
    # 18 maps, each one domain from the last, every seed the same ones
    assert len(seen) == 18
    assert all((c.tobytes() in seen) for c in a.cycle)


def test_cycle_turns_each_domain_once_and_back():
    base = weld.weld_maps(0, CFG).angles
    cyc = traffic.cycle(base, 10, 1)
    assert len(cyc) == 18
    np.testing.assert_array_equal(cyc[0], base)
    for k in range(18):
        turn = (cyc[(k + 1) % 18] - cyc[k]) % 180
        assert (turn != 0).sum() == 1


def test_negative_and_huge_seeds():
    for seed in (-3, 2 ** 40 + 1):
        t = traffic.Traffic(load(BENCH, "traffic", "chain.json"), CFG, seed)
        t.next()
