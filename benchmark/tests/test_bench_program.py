"""The readers of the program's own ranges (``lib/program.py``) on a small
recorded Chrome trace (``data/trace_program.json``): the two calls of
``data/trace_small.json`` with a call's ``alifmm.`` ranges added."""

import os

import pytest

from _tiny import BENCH, load

from benchmark.lib import harness, program

DATA = load(BENCH, "tests", "data", "trace_program.json")

# over the two calls: build.planes 200 us, build.tables 50, build.upload
# 30, four facade.read of 10, one facade.convert of 10; 2 validate.read +
# 2 pass.read + 4 facade.read; idle gaps (midpoint): 1000-1410 (1205,
# build.planes), 1490-1600 (1545, the second pass inside stage.final),
# 1750-1860 (1805, the call alone), 1930-2000 (1965, a facade.read): 110
# us in a pass, none in a stage outside a pass
EXPECTED = {
    "build_planes_s": 100e-6,
    "build_tables_s": 25e-6,
    "build_upload_s": 15e-6,
    "facade_copy_s": 20e-6,
    "facade_convert_s": 5e-6,
    "host_reads": 4.0,
    "pass_idle_s": 55e-6,
    "stage_idle_s": 0.0,
}


def traced():
    return harness.TracedRun(DATA["calls"], DATA["traceEvents"])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_program_reader(name):
    assert harness._reader(name)(traced()) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_program_reader_finds_nothing_to_read(name):
    empty = harness.TracedRun([dict(call_s=1.0, spans={}, builds=0,
                                    k1_launches=0, k1_bound_s=0.0)], [])
    assert harness._reader(name)(empty) is None


def test_idle_by_innermost_range():
    assert program.idle_by_range(traced()) == pytest.approx({
        "alifmm.build.planes": 205e-6, "alifmm.pass": 55e-6,
        "alifmm.call.find_all_TTF_rays_parallel": 55e-6,
        "alifmm.facade.read": 35e-6})


def test_bench_attribution_ignores_the_program_ranges():
    gaps = dict(harness.idle_gaps(traced().events))
    assert gaps == pytest.approx({"bench.make_model": 410e-6,
                                  "host, between calls": 180e-6,
                                  "bench.stage_final": 110e-6})


def test_data_file_is_small():
    assert os.path.getsize(os.path.join(BENCH, "tests", "data",
                                        "trace_program.json")) < 16384
