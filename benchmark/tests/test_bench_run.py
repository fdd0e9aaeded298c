"""Whole runs: no card and no program means no result; on the CPU, with the
look for a card skipped, a tiny cell is correct, its bfloat16 control is
not, and each planted fault turns ``correct`` false."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from _tiny import BENCH, ROOT, cut_solver, load, make_root, run

from benchmark.lib import faults

# the tiny weld's own sound residuals sit above weld_qp's limits (24 x 30
# cells, one patch stage: its fields are further from their fixpoint
# under the production budget); these limits hold the tiny cells to
# about twice them, below the tiny control's
TINY = {
    "tiny.chain": dict(residual_p50=1e-3, residual_p90=3e-3),
    "tiny.tfm": dict(residual_p50=1e-3, residual_p90=3e-3),
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("tiny")), TINY)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "weld_qp.chain",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_bare_checkout_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path.insert(0, '.'); "
            "from benchmark.lib import harness; "
            "harness.run('weld_qp.chain', 3, 1, 0, time.perf_counter(), "
            "device='cpu')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "alifmm_tpu_torch" in p.stderr


@pytest.mark.parametrize("cell", ["tiny.chain", "tiny.tfm"])
def test_tiny_cell_correct_and_its_control_not(root, cell, monkeypatch):
    cut_solver(monkeypatch)
    r = run(root, cell, control=True)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert not r["control_correct"], r["control_checks"]
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"inspection_s", "peak_mem_gb", "setup_s"}
    json.dumps(r)
    if cell == "tiny.chain":
        # the control fails the ray times at weld_qp.chain's own limit
        lim = load(BENCH, "limits", "weld_qp.chain.json")["ray_time_gap"]
        assert r["checks"]["ray_time_gap"]["value"] <= lim
        assert r["control_checks"]["ray_time_gap"] > lim


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", ["tiny.chain", "tiny.tfm"])
def test_planted_fault_is_not_correct(root, cell, fault, monkeypatch):
    cut_solver(monkeypatch)
    with faults.planted(fault, rays=cell.endswith("chain")):
        r = run(root, cell)
    assert not r["correct"], r["checks"]


def test_traced_run_reports_per_layer_metrics(root, monkeypatch):
    cut_solver(monkeypatch)
    r = run(root, "tiny.chain", trace=1)
    assert r["correct"]
    spec = load(ROOT, "BENCHMARK.json")
    # the CPU has no device trace: the readers of spans and counters read,
    # the device's readers find nothing
    want = {m["name"] for m in spec["per_layer"]} - {"k1_roofline",
                                                      "device_idle"}
    assert set(r["metrics"]) == want
    assert r["metrics"]["model_builds"]["value"] == 2.0
    assert "breakdown" in r


@pytest.mark.gpu
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "weld_qp.chain",
         "--seed", str(2 ** 31 + 3), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]


def _run_main(root, monkeypatch, trace):
    """``benchmark/run.py``'s ``main`` on the tiny cell, on the CPU."""
    from benchmark import run as run_py
    from benchmark.lib import harness

    real = harness.run
    monkeypatch.setattr(
        harness, "run", lambda w, s, sec, tr, t0: real(
            w, s, sec, tr, t0, device="cpu", root=root))
    with torch.inference_mode():
        return run_py.main(["--workload", "tiny.chain", "--seed",
                            str(2 ** 31 + 17), "--seconds", "0.5",
                            "--trace", str(trace)])


@pytest.mark.parametrize("where", ["check", "reader"])
def test_jax_loaded_after_the_window_no_result(root, where, monkeypatch,
                                                capsys):
    """A forbidden module that the check or a metric's reader loads, once
    the window has closed, still keeps the run from printing a result."""
    import types

    from benchmark.lib import harness

    cut_solver(monkeypatch)

    def load_jax():
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))

    if where == "check":
        real_check = harness.check

        def check(*args, **kw):
            load_jax()
            return real_check(*args, **kw)
        monkeypatch.setattr(harness, "check", check)
    else:
        real_reader = harness._reader

        def reader(name):
            read = real_reader(name)

            def wrapped(run):
                load_jax()
                return read(run)
            return wrapped
        monkeypatch.setattr(harness, "_reader", reader)
    rc = _run_main(root, monkeypatch, trace=int(where == "reader"))
    out = capsys.readouterr()
    assert rc == 2
    assert out.out.strip() == ""
    assert "forbidden modules loaded: ['jax']" in out.err


def test_run_main_prints_result_last(root, monkeypatch, capsys):
    cut_solver(monkeypatch)
    assert _run_main(root, monkeypatch, trace=0) == 0
    out = capsys.readouterr()
    r = json.loads(out.out.strip().splitlines()[-1])
    assert r["correct"]
    assert out.err.strip().splitlines()[-1].startswith("check ")


def test_reference_model_built_once_a_map(root, monkeypatch):
    """The check builds the reference's model once for each map the
    window sent (and once more for a sampled call's fields)."""
    from benchmark.lib import harness, traffic
    from benchmark.reference import model

    cut_solver(monkeypatch)
    real_cycle = traffic.cycle
    built = []
    real = model.RefModel.__init__

    def init(self, veln, *args, **kw):
        built.append((np.asarray(veln).tobytes(), kw.get("planes", True)))
        real(self, veln, *args, **kw)
    monkeypatch.setattr(model.RefModel, "__init__", init)
    # a cycle of two maps, so that the window repeats each, and a clock
    # that lets the window make four calls
    monkeypatch.setattr(traffic, "cycle", lambda *a: real_cycle(*a)[:2])
    ticks = iter(range(10 ** 6))
    monkeypatch.setattr(harness, "_now", lambda: 0.05 * next(ticks))
    r = run(root, "tiny.chain")
    assert r["correct"]
    assert r["attempted"] >= 3
    assert len(built) == len(set(built))
    assert len([b for b in built if not b[1]]) == 2


def test_field_sample_repeats_per_seed_and_reaches_every_call():
    from benchmark.lib.harness import FIELD_CALLS, FieldSample

    def draw(seed, n=40):
        s = FieldSample(seed)
        for k in range(n):
            s.offer(k, np.zeros(1))
        return sorted(w for w, _ in s.items)

    assert draw(5) == draw(5)
    assert len(draw(5)) == FIELD_CALLS
    assert set().union(*(draw(2 ** 31 + k) for k in range(200))) == set(
        range(40))
    assert draw(3, n=2) == [0, 1]
