"""The port imports neither JAX nor the JAX package: every module of
``coral_tpu_torch`` loads, and the main path runs, in a process where
importing ``jax``, ``jaxlib`` or ``coral_tpu`` fails (as on a machine with
a GPU that has neither), and no file under ``coral_tpu/`` is opened."""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCK = r'''
import sys

BLOCKED = ("jax", "jaxlib", "coral_tpu")


class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")


sys.meta_path.insert(0, _Blocker())
'''

CHECK = r'''
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
with open("/proc/self/maps") as fh:
    mapped = [ln.split()[-1] for ln in fh if "/coral_tpu/" in ln]
assert not mapped, mapped
'''


def _run(body: str, tmp_path) -> str:
    proc = subprocess.run(
        [sys.executable, "-c", BLOCK + body + CHECK],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "TMPDIR": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def test_blocker_blocks_only_the_exact_names(tmp_path):
    out = _run(r'''
for name in BLOCKED:
    try:
        __import__(name)
    except ImportError:
        continue
    raise AssertionError(f"{name} imported")
import coral_tpu_torch
print("ok")
''', tmp_path)
    assert out.split()[-1] == "ok"


def test_every_module_imports_without_jax(tmp_path):
    out = _run(r'''
import importlib
import pkgutil

import coral_tpu_torch

names = [m.name for m in pkgutil.walk_packages(coral_tpu_torch.__path__,
                                               "coral_tpu_torch.")
         if not m.name.endswith("__main__")]
for n in names:
    importlib.import_module(n)
assert {"coral_tpu_torch.parallel.mesh", "coral_tpu_torch.parallel.sharded",
        "coral_tpu_torch.parallel.multihost",
        "coral_tpu_torch.parallel.distributed"} <= set(names), names
print(len(names))
''', tmp_path)
    assert int(out.split()[-1]) >= 40


def test_pair_scoring_runs_without_jax(tmp_path):
    """score_pairs_l on the table of a simulated sample, and
    subset_to_bps_batch on the native ChimeraStore (whose flat_table()
    lands on the port's own ops.pairs), with the native library built by
    the port."""
    _run(r'''
from coral_tpu_torch.io.bam import BamFile
from coral_tpu_torch.native import bamcore
from coral_tpu_torch.ops.chimera import ChimeraStore, collect_chimeras
from coral_tpu_torch.ops.pairs import score_pairs_l, subset_to_bps_batch
from coral_tpu_torch.sim import simulate_ecdna

bam, _, _ = simulate_ecdna(%r, jitter=0)
bamf = BamFile(bam)
assert bamf.backend == "native"
assert "build/coral_tpu_torch/libbamcore_" in bamcore._load()._name
_, store, _ = collect_chimeras(bamf)
assert isinstance(store, ChimeraStore)
ivs = [["chr7", 55_000_000, 55_400_000, 0], ["chr8", 1_000, 2_000, 0]]
for engine in ("numpy", "torch"):
    pi, pj, hit = score_pairs_l(store.flat_table(), ivs, 100, 20, 100,
                                engine=engine, device="cpu")
    assert len(pi) and hit.any()
rows = subset_to_bps_batch(store, sorted(store.names),
                           ["chr7", 55_000_000, 55_200_000],
                           ["chr7", 55_200_000, 55_400_000], 100, 20,
                           as_table=True)
assert len(rows) > 0
bamf.close()
''' % str(tmp_path), tmp_path)


def test_coverage_and_clustering_run_without_jax(tmp_path):
    """``ops/coverage.py`` loads and answers, and ``cluster_breakpoints``
    takes its match matrix from the port's own kernels module, with
    ``jax`` and ``coral_tpu`` blocked."""
    _run(r'''
import numpy as np
from coral_tpu_torch.ops.breakpoints import cluster_breakpoints
from coral_tpu_torch.ops.coverage import CoverageIndex, bin_coverage

s = np.array([0, 50, 120]); e = np.array([100, 150, 130])
index = CoverageIndex(s, e, device="cpu")
want = [150, 60, 0]
assert index.bin_histogram(0, 100, 3).tolist() == want
assert bin_coverage(s, e, 0, 100, 3, device="cpu").tolist() == want
assert index.interval_coverage([40], [60]).tolist() == [30]
bps = [["chr1", 100 + k, "+", "chr1", 900 + k, "-", ("r", 0, 1), 0, 0,
        60, 60] for k in range(4)]
assert len(cluster_breakpoints(bps, 2, 50, engine="torch",
                               device="cpu")) == 1
''', tmp_path)


def test_reconstruct_cli_runs_without_jax(tmp_path):
    """The whole main path through the port's CLI, on the CPU."""
    _run(r'''
import os
from coral_tpu_torch.cli import main
from coral_tpu_torch.sim import simulate_ecdna

out = %r
bam, cns, seeds = simulate_ecdna(out, jitter=0)
prefix = os.path.join(out, "p")
assert main(["reconstruct", "--lr_bam", bam, "--cnv_seed", seeds,
             "--cn_seg", cns, "--output_prefix", prefix, "--engine", "torch",
             "--cn_engine", "torch", "--device", "cpu",
             "--log_fn", os.path.join(out, "p.log")]) == 0
assert os.path.exists(prefix + "_amplicon1_graph.txt")
assert os.path.exists(prefix + "_amplicon1_cycles.txt")
''' % str(tmp_path), tmp_path)


def test_no_import_of_the_jax_package_in_the_sources():
    """No line of ``coral_tpu_torch/**`` or ``chip_smoke.py`` imports
    ``coral_tpu``, ``tools``, ``bench`` or JAX."""
    pat = re.compile(r"^\s*(from|import)\s+"
                     r"(coral_tpu|tools|bench|__graft_entry__|jax|jaxlib)"
                     r"(\.|\s|$)")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "coral_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 35
    bad = []
    for path in files:
        with open(path) as fh:
            bad += [f"{os.path.relpath(path, ROOT)}:{i}: {ln.rstrip()}"
                    for i, ln in enumerate(fh, 1) if pat.match(ln)]
    assert not bad, "\n".join(bad)


def test_user_pipeline_runs_without_jax_or_matplotlib(tmp_path):
    """``seed`` -> ``reconstruct --cn_engine batch`` -> ``cycle2bed``
    through the port's CLI on the CPU, with matplotlib blocked as well:
    the machine with the card has none, and only ``hsr`` and ``plot``
    need it."""
    _run(r'''
import os

BLOCKED = BLOCKED + ("matplotlib",)
from coral_tpu_torch.cli import main
from coral_tpu_torch.sim import simulate_ecdna

out = %r
bam, cns, _ = simulate_ecdna(out, jitter=0)
seeds = os.path.join(out, "seeds.bed")
assert main(["seed", "--cn_seg", cns, "--out", seeds]) == 0
with open(seeds) as fh:
    assert fh.read().strip()
prefix = os.path.join(out, "p")
assert main(["reconstruct", "--lr_bam", bam, "--cnv_seed", seeds,
             "--cn_seg", cns, "--output_prefix", prefix, "--engine", "torch",
             "--cn_engine", "batch", "--device", "cpu",
             "--log_fn", os.path.join(out, "p.log")]) == 0
with open(os.path.join(out, "p.log")) as fh:
    assert "CN balance route: engine=batch" in fh.read()
for flags in ([], ["--rotate_to_min"]):
    bed = os.path.join(out, "c%%d.bed" %% len(flags))
    assert main(["cycle2bed", "--cycle_fn", prefix + "_amplicon1_cycles.txt",
                 "--output_fn", bed, *flags]) == 0
    with open(bed) as fh:
        assert [ln for ln in fh if not ln.startswith("#")]
''' % str(tmp_path), tmp_path)


def test_distributed_worker_mains_run_without_jax(tmp_path):
    """``python -m coral_tpu_torch.parallel.distributed`` in a 1-process
    gloo group, both mains (the histogram, then the pipeline with cycles),
    with ``jax`` and ``coral_tpu`` blocked."""
    _run(r'''
import os
import runpy

import numpy as np
from coral_tpu_torch.parallel.multihost import split_bam
from coral_tpu_torch.sim import simulate_ecdna

out = %r
bam, cns, seeds = simulate_ecdna(out, jitter=0)
shard = split_bam(bam, [os.path.join(out, "s0.bam")])[0]
for k, args in enumerate((
        [shard, "chr7", "54000000", "100000", "64",
         os.path.join(out, "h.npy")],
        ["pipeline", seeds, cns, os.path.join(out, "p"), shard])):
    head = ["0", "1", "file://" + os.path.join(out, "rdzv%%d" %% k), "gloo",
            "cpu"]
    sys.argv = ["distributed"] + (args[:1] + head + args[1:]
                                  if args[0] == "pipeline" else head + args)
    runpy.run_module("coral_tpu_torch.parallel.distributed",
                     run_name="__main__")
assert np.load(os.path.join(out, "h.npy")).sum() > 0
assert os.path.exists(os.path.join(out, "p.p0_amplicon1_cycles.txt"))
''' % str(tmp_path), tmp_path)
