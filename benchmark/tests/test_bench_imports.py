"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port either: top-level names compared
whole (the port's name begins with the JAX package's)."""

import ast
import os

import pytest

from _tiny import BENCH

JAX = {"jax", "jaxlib", "flax", "alifmm_tpu"}


def imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def sources(sub=""):
    out = []
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("path", sources(), ids=lambda p: os.path.relpath(
    p, BENCH))
def test_no_jax(path):
    assert not imported_tops(path) & JAX


def test_reference_imports_nothing_of_the_port():
    for path in sources("reference"):
        assert not imported_tops(path) & (JAX | {"alifmm_tpu_torch",
                                                 "benchmark"}), path


def test_whole_names_compared():
    # the port's own name is not the JAX package's
    assert "alifmm_tpu_torch" not in JAX
    assert imported_tops(os.path.join(BENCH, "lib", "spans.py")) & {
        "alifmm_tpu_torch"} == {"alifmm_tpu_torch"}


def code_strings(path):
    """The string constants of a module that are not docstrings."""
    tree = ast.parse(open(path).read(), path)
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_nothing_reads_the_jax_era_bench():
    for path in sources():
        if os.path.basename(os.path.dirname(path)) == "tests":
            continue
        for s in code_strings(path):
            for word in ("bench.py", "bench_data", "BENCH_r", "MULTICHIP"):
                assert word not in s, (path, word)
