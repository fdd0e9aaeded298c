"""BENCHMARK.json against the benchmark's contract, and every part of
every cell found by its name."""

import ast
import json
import os
import re

import pytest

from _tiny import BENCH, ROOT, load

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = load(ROOT, "BENCHMARK.json")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert os.path.isdir(os.path.join(ROOT, p))
        assert not p.endswith("_torch")
    for word in SPEC["command"]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    entries = SPEC[kind]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.fullmatch(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
                assert "\t" not in e[key]
        for k in e.get("reduced", []):
            assert NAME.fullmatch(k)


def test_metrics():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    assert len(layers) >= 5


def test_every_part_found_by_name():
    confs = {c["name"]: c for c in SPEC["configs"]}
    pairs = set()
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4)
        assert w["config"] in confs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.isfile(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
        lim = load(BENCH, "limits", w["name"] + ".json")
        assert all(isinstance(v, (int, float)) for v in lim.values())
        for m in SPEC["per_layer"]:
            if w["name"] in m.get("workloads", [w["name"]]):
                assert os.path.isfile(os.path.join(BENCH, "metrics",
                                                   m["name"] + ".py"))
    assert len(pairs) == len(SPEC["workloads"])
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == set(confs)
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert c["file"].startswith(SPEC["paths"][0] + "/")
        cfg = load(ROOT, c["file"])
        assert cfg["name"] == c["name"]


def test_readers_define_read():
    for m in SPEC["per_layer"]:
        path = os.path.join(BENCH, "metrics", m["name"] + ".py")
        tree = ast.parse(open(path).read())
        assert any(isinstance(n, ast.FunctionDef) and n.name == "read"
                   for n in tree.body), path
