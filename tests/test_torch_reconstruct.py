"""The port's reconstruct (``coral_tpu_torch.reconstruct`` and its CLI)
against the JAX package's: graph and cycles files byte-identical.

Both sides use the numpy CN engine (the port's ``auto``), so CN values
are the same float64 numbers and the files agree to the byte.
"""
import ast
import dataclasses
import difflib
import os
import subprocess
import sys

import pytest
import torch

from coral_tpu.config import DEFAULT_CONFIG
from coral_tpu.reconstruct import reconstruct_cycles, reconstruct_graphs
from coral_tpu.sim import simulate_ecdna, simulate_mixed_sample
from coral_tpu_torch.cli import main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference(bam, cns, seeds, prefix):
    cfg = DEFAULT_CONFIG.replace(engine=dataclasses.replace(
        DEFAULT_CONFIG.engine, cn_engine="numpy"))
    rec = reconstruct_graphs(bam, seeds, cns, prefix, cfg=cfg)
    reconstruct_cycles(rec, prefix)
    rec.bam.close()


def _outputs(d, base):
    return sorted(f[len(base):] for f in os.listdir(d)
                  if f.startswith(base)
                  and f.endswith(("_graph.txt", "_cycles.txt")))


def _assert_identical(d, ref, port):
    names = _outputs(d, ref)
    assert names and names == _outputs(d, port)
    assert any(n.endswith("_cycles.txt") for n in names)
    for n in names:
        with open(os.path.join(d, ref + n), "rb") as a, \
                open(os.path.join(d, port + n), "rb") as b:
            assert a.read() == b.read(), n


def _args(bam, cns, seeds, prefix, engine):
    return ["reconstruct", "--lr_bam", bam, "--cnv_seed", seeds,
            "--cn_seg", cns, "--output_prefix", prefix, "--engine", engine,
            "--device", "cpu", "--log_fn", prefix + ".log"]


def test_mixed_sample_cli_byte_identical(tmp_path):
    """``python -m coral_tpu_torch reconstruct --engine torch --device
    cpu`` on the three-class mixed sample (ecDNA, BFB, translocation)."""
    d = str(tmp_path)
    bam, cns, seeds = simulate_mixed_sample(d, seed=3)
    _reference(bam, cns, seeds, os.path.join(d, "ref"))
    proc = subprocess.run(
        [sys.executable, "-m", "coral_tpu_torch",
         *_args(bam, cns, seeds, os.path.join(d, "port"), "torch")],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    _assert_identical(d, "ref", "port")
    assert len(_outputs(d, "ref")) == 6


@pytest.mark.parametrize("engine", ["torch", "numpy"])
def test_ecdna_byte_identical(tmp_path, engine):
    d = str(tmp_path)
    bam, cns, seeds = simulate_ecdna(d, jitter=2)
    _reference(bam, cns, seeds, os.path.join(d, "ref"))
    assert main(_args(bam, cns, seeds, os.path.join(d, "port"), engine)) == 0
    _assert_identical(d, "ref", "port")


def test_cli_help_and_cuda_request(tmp_path, capsys):
    assert main([]) == 1
    assert "reconstruct" in capsys.readouterr().out
    if torch.cuda.is_available():
        return
    d = str(tmp_path)
    bam, cns, seeds = simulate_ecdna(d, jitter=0)
    args = _args(bam, cns, seeds, os.path.join(d, "p"), "cuda")
    args[args.index("--device") + 1] = "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        main(args)


# The only functions of the port's reconstruct.py that may differ from
# the JAX package's: they carry the device (and no longer the mesh), and
# the two entry points run their stages under the port's tracing spans.
PLUMBING = {"find_breakpoints", "compute_cn", "reconstruct_graphs",
            "reconstruct_cycles"}


def _allowed_lines(src: str):
    tree = ast.parse(src)
    allowed = set(range(1, tree.body[0].end_lineno + 1))   # docstring
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name in PLUMBING:
            allowed.update(range(node.lineno, node.end_lineno + 1))
    return allowed


def test_reconstruct_drift_guard():
    """``coral_tpu_torch/reconstruct.py`` is ``coral_tpu/reconstruct.py``
    but for import lines, the device plumbing and the stage spans: any
    other edit to either file must be made to both."""
    with open(os.path.join(ROOT, "coral_tpu", "reconstruct.py")) as fh:
        src_j = fh.read()
    with open(os.path.join(ROOT, "coral_tpu_torch", "reconstruct.py")) as fh:
        src_t = fh.read()
    lines_j = src_j.splitlines()
    lines_t = src_t.splitlines()
    ok_j, ok_t = _allowed_lines(src_j), _allowed_lines(src_t)

    def fine(line: str, lineno: int, ok) -> bool:
        s = line.strip()
        return (lineno in ok or not s or s.startswith(("from ", "import "))
                or "device" in s or s.startswith("def __init__("))

    bad = []
    sm = difflib.SequenceMatcher(None, lines_j, lines_t, autojunk=False)
    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        if tag == "equal":
            continue
        bad += [f"coral_tpu:{i + 1}: {lines_j[i]}" for i in range(i1, i2)
                if not fine(lines_j[i], i + 1, ok_j)]
        bad += [f"coral_tpu_torch:{j + 1}: {lines_t[j]}"
                for j in range(j1, j2) if not fine(lines_t[j], j + 1, ok_t)]
    assert not bad, "\n".join(bad)
    # the JAX-touching imports are the port's own
    assert "from .graph.cn_solver import compute_cn" in src_t
    assert "from .ops.pairs import find_breakpoints_device" in src_t
    assert "from .ops.pairs import subset_to_bps_batch" in src_t
