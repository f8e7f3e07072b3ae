"""Every host module that the port copied from the JAX package equals its
original but for import lines, the module docstring and a stated list of
functions or lines: any other edit to either file must be made to both.

Besides the functions listed, a few comment lines differ in one word or in
how they name a file of the reference implementation; they are listed by
a piece of text that both versions of the line share.  A copy listed as
None equals its original byte for byte.  The files the port rewrote,
among them its native BAM core, are held to the JAX package by their
outputs instead (``native/bamcore.cpp``: ``tests/test_torch_bam_native.py``)."""
import ast
import difflib
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# relative path -> (functions, classes or module-level names that may
# differ, substrings or patterns of other lines that may differ)
COPIES = {
    "constants.py": ((), ("global_names.py:9-25",)),
    "config.py": ((), ()),
    # the trace file hangs on the port's own package logger; the spans
    # and the counters are the port's own
    "tracing.py": (("setup_file_logging", "SpanRecord", "MAX_SPANS", "SPANS",
                    "_enabled", "_seq", "_lock", "enable", "disable", "last_seq",
                    "spans_since", "_record", "_NoSpan", "_NO_SPAN", "_Span",
                    "span", "COUNTERS", "_counts", "count", "counters"), ()),
    "sim.py": ((), ()),
    "io/__init__.py": ((), ()),
    "io/bgzf.py": ((), ()),
    "io/cnv.py": ((), ()),
    "io/bamwrite.py": ((), ()),
    # the native library is built by the port, not found beside the module;
    # the native region decodes run under spans
    "io/bam.py": (("_native_available", "coverage_sum", "coverage_profile",
                   "del_gap_alignments"), ()),
    "native/__init__.py": ((), ()),
    # the scan runs under a span; the library's counters are read
    "native/bamcore.py": (("_load", "scan_into", "COUNTERS", "counters"),
                          ("_SO_PATH",)),
    "native/walkenum.py": (("_load", "available"), ("_SO_PATH",)),
    "native/walkenum.cpp": ((), ("mirrors the Python",
                                 "mirroring the Python")),
    "native/Makefile": None,
    "ops/layout.py": ((), ()),
    # the native SA parse runs under a span
    "ops/chimera.py": (("collect_chimeras",), ()),
    # the device engine takes its match matrix from the port's kernel K9
    # (engines torch and cuda on a device, uint8 cells) where the original
    # goes to the Pallas kernel (engine pallas, interpret, int32 cells)
    "ops/breakpoints.py": (("cluster_breakpoints", "_cluster_group_device"),
                           ("# device-path group-size", "# modest (4096**2")),
    "graph/breakpoint_graph.py": ((), ()),
    "cycles/__init__.py": ((), ()),
    "cycles/candidates.py": ((), ("suboptimal and the decomposition",)),
    "cycles/eulerian.py": ((), ()),
    "cycles/path_constraints.py": ((), ()),
    "cycles/output.py": ((), ("our candidate pool can",)),
    # the walk enumerations and the MILP solves run under spans and count
    # the walks, path constraints and MILP sizes
    "cycles/decomposition.py": (("cycle_decomposition",
                                 "_solve_selection_milp"),
                                ("keeps the reference's model-size gate",
                                 "Per-amplicon decomposition")),
    "cycles/colgen.py": ((), ("cycle_decomposition.py:179-332",
                              "an admissible bound otherwise")),
    "cycles/refmodel.py": ((), ()),
    "annotations.py": ((), ()),
    "annotations_bushman.py": ((), ()),
    "seed.py": ((), ()),
    "cycle2bed.py": ((), ()),
    "hsr.py": ((), ()),
    "plot/__init__.py": ((), ()),
    "plot/plot_amplicons.py": ((), ()),
    "parallel/__init__.py": ((), ()),
    # the pipeline after the merge runs its device engines on ``device``
    "parallel/multihost.py": (("multihost_reconstruct_graphs",), ()),
}


# functions the port copied into a module it rewrote: (relative path,
# function) -> substrings of lines that may differ
FUNCTION_COPIES = {
    # one system, so ``auto`` is the numpy engine; the port's
    # ``_assign_solution`` names the device where the engines run
    ("graph/cn_solver.py", "compute_cn_hybrid"): (
        "_assign_solution(", "auto`` is the numpy engine"),
}


def _read(pkg, rel):
    with open(os.path.join(ROOT, pkg, rel)) as fh:
        return fh.read()


def _allowed_lines(rel: str, src: str, functions):
    if not rel.endswith(".py"):
        return set()
    tree = ast.parse(src)
    allowed = set()
    if tree.body and isinstance(tree.body[0], ast.Expr) \
            and isinstance(tree.body[0].value, ast.Constant):
        allowed.update(range(1, tree.body[0].end_lineno + 1))   # docstring
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                and node.name in functions:
            allowed.update(range(node.lineno, node.end_lineno + 1))
    for node in tree.body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign)
                   else [])
        if any(isinstance(t, ast.Name) and t.id in functions
               for t in targets):
            allowed.update(range(node.lineno, node.end_lineno + 1))
    return allowed


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copied_module_drift_guard(rel):
    src_j, src_t = _read("coral_tpu", rel), _read("coral_tpu_torch", rel)
    if COPIES[rel] is None:
        assert src_j == src_t
        return
    functions, substrings = COPIES[rel]
    lines_j, lines_t = src_j.splitlines(), src_t.splitlines()
    ok_j = _allowed_lines(rel, src_j, functions)
    ok_t = _allowed_lines(rel, src_t, functions)

    def fine(line: str, lineno: int, ok) -> bool:
        s = line.strip()
        return (lineno in ok or not s
                or (rel.endswith(".py")
                    and s.startswith(("from ", "import ")))
                or any(sub in s for sub in substrings))

    bad = []
    sm = difflib.SequenceMatcher(None, lines_j, lines_t, autojunk=False)
    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        if tag == "equal":
            continue
        bad += [f"coral_tpu/{rel}:{i + 1}: {lines_j[i]}"
                for i in range(i1, i2) if not fine(lines_j[i], i + 1, ok_j)]
        bad += [f"coral_tpu_torch/{rel}:{j + 1}: {lines_t[j]}"
                for j in range(j1, j2) if not fine(lines_t[j], j + 1, ok_t)]
    assert not bad, "\n".join(bad)
    assert "coral_tpu." not in "\n".join(
        ln for ln in lines_t if ln.strip().startswith(("from ", "import ")))


def _function_lines(src: str, name: str):
    (node,) = [n for n in ast.parse(src).body
               if isinstance(n, ast.FunctionDef) and n.name == name]
    return src.splitlines()[node.lineno - 1:node.end_lineno]


@pytest.mark.parametrize("rel,name", sorted(FUNCTION_COPIES))
def test_copied_function_drift_guard(rel, name):
    """A function copied into a rewritten module equals its original but
    for the listed lines: an edit to either must be made to both."""
    lines_j = _function_lines(_read("coral_tpu", rel), name)
    lines_t = _function_lines(_read("coral_tpu_torch", rel), name)
    subs = FUNCTION_COPIES[rel, name]
    bad = []
    sm = difflib.SequenceMatcher(None, lines_j, lines_t, autojunk=False)
    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        if tag != "equal":
            bad += [ln for ln in lines_j[i1:i2] + lines_t[j1:j2]
                    if not any(sub in ln for sub in subs)]
    assert not bad, "\n".join(bad)
    assert len(lines_t) > 10


def test_every_copy_is_guarded():
    """Each file of the port that has a namesake in the JAX package is
    either in the list above or one of the modules the port rewrote."""
    rewritten = {"__init__.py", "__main__.py", "cli.py", "reconstruct.py",
                 "graph/__init__.py", "graph/cn_solver.py", "ops/__init__.py",
                 "ops/pairs.py", "ops/scoring.py", "ops/coverage.py",
                 "ops/routing.py", "native/bamcore.cpp",
                 "parallel/mesh.py", "parallel/sharded.py",
                 "parallel/distributed.py"}
    found = set()
    top = os.path.join(ROOT, "coral_tpu_torch")
    for d, _, names in os.walk(top):
        for n in names:
            rel = os.path.relpath(os.path.join(d, n), top)
            if "__pycache__" in rel or rel.endswith((".so", ".pyc")):
                continue
            if os.path.exists(os.path.join(ROOT, "coral_tpu", rel)):
                found.add(rel)
    assert found - rewritten == set(COPIES)
