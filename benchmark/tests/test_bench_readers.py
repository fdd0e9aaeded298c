"""Each per-layer metric's reader on a small recorded Chrome trace
(``data/trace_small.json``: two calls; K1 200 us, a copy 30 us, K2 two
overlapping launches; the window 1000 us)."""

import os

import pytest

from _tiny import BENCH, ROOT, load

from benchmark.lib import harness

DATA = load(BENCH, "tests", "data", "trace_small.json")

EXPECTED = {
    "facade_host_s": 0.2,
    "model_build_s": 0.25,
    "model_builds": 2.0,
    "patch_stages_s": 0.1,
    "final_stage_s": 0.25,
    "k1_launches": 39.0,
    "rays_s": 0.1,
    # bounds 6 us over K1's 200 us
    "k1_roofline": 3.0,
    # busy 80 + 150 (a kernel and the copy after it) + 70 (two
    # overlapping launches) of 1000 us
    "device_idle": 0.7,
}


def traced():
    return harness.TracedRun(DATA["calls"], DATA["traceEvents"])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader(name):
    assert harness._reader(name)(traced()) == pytest.approx(EXPECTED[name])


def test_every_metric_has_a_case():
    spec = load(ROOT, "BENCHMARK.json")
    assert {m["name"] for m in spec["per_layer"]} == set(EXPECTED)


def test_readers_find_nothing_to_read():
    empty = harness.TracedRun([dict(call_s=1.0, spans={}, builds=0,
                                    k1_launches=0, k1_bound_s=0.0)], [])
    for name in ("rays_s", "k1_roofline", "device_idle", "model_build_s",
                 "final_stage_s", "patch_stages_s"):
        assert harness._reader(name)(empty) is None, name


def test_breakdown():
    run = traced()
    assert [n for n, _ in harness.yardstick.top_device_ops(run.events)][:1] \
        == ["void (anonymous namespace)::sweep_pass_kernel<float, 4>"
            "(Args<float>)"]
    gaps = dict(harness.idle_gaps(run.events))
    assert gaps == pytest.approx({"bench.make_model": 410e-6,
                                  "host, between calls": 180e-6,
                                  "bench.stage_final": 110e-6})
    busy, window = harness.yardstick.busy_share(run.events, run.t0_us,
                                                run.t1_us)
    assert (busy, window) == pytest.approx((300e-6, 1000e-6))


def test_data_file_is_small():
    assert os.path.getsize(os.path.join(BENCH, "tests", "data",
                                        "trace_small.json")) < 16384
