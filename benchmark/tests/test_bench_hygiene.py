"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names; the reference and the generator import nothing of
the program either."""
import ast
import os
import sys

import run
from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "coral_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _modules():
    for d, _, names in os.walk(BENCH):
        if "__pycache__" in d:
            continue
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


def test_no_module_imports_jax_or_the_jax_package():
    bad = {p: sorted(set(_imports(p)) & FORBIDDEN) for p in _modules()}
    assert not {p: v for p, v in bad.items() if v}
    assert "coral_tpu_torch" not in FORBIDDEN      # whole names only


def test_reference_and_traffic_import_nothing_of_the_program():
    for sub in ("reference", "traffic"):
        for p in _modules():
            if os.sep + sub + os.sep in p:
                assert "coral_tpu_torch" not in set(_imports(p)), p


def test_run_time_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "coral_tpu_torch_x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "coral_tpu.ops", sys)
    assert run.forbidden_modules() == ["coral_tpu"]
