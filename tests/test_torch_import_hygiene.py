"""The port never imports JAX: every module of ``coral_tpu_torch`` loads,
and the main path runs, in a process where importing ``jax`` fails (as
it does on a machine with a GPU and no JAX)."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCK_JAX = r'''
import sys


class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{name} is blocked")


sys.meta_path.insert(0, _NoJax())
'''

CHECK_NO_JAX = r'''
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
assert not leaked, leaked
'''


def _run(body: str, tmp_path) -> str:
    proc = subprocess.run(
        [sys.executable, "-c", BLOCK_JAX + body + CHECK_NO_JAX],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "TMPDIR": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


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
print(len(names))
''', tmp_path)
    assert int(out.split()[-1]) >= 10


def test_pair_scoring_runs_without_jax(tmp_path):
    """score_pairs_l on a small table, and subset_to_bps_batch on a native
    ChimeraStore (whose flat_table() would import coral_tpu.ops.pairs and
    with it JAX)."""
    _run(r'''
from __graft_entry__ import _synthetic_chimeras
from coral_tpu.io.bam import BamFile
from coral_tpu.ops.chimera import collect_chimeras
from coral_tpu.sim import simulate_ecdna
from coral_tpu_torch.ops.pairs import (build_chimera_table, score_pairs_l,
                                       subset_to_bps_batch)

chims, ivs = _synthetic_chimeras(n_reads=70)
pi, pj, hit = score_pairs_l(build_chimera_table(chims), ivs, 100, 20, 100,
                            engine="torch", device="cpu")
assert len(pi) and hit.any() and not hit.all()
bam, _, _ = simulate_ecdna(%r, jitter=0)
bamf = BamFile(bam)
_, store, _ = collect_chimeras(bamf)
rows = subset_to_bps_batch(store, sorted(store.names),
                           ["chr7", 55_000_000, 55_200_000],
                           ["chr7", 55_200_000, 55_400_000], 100, 20,
                           as_table=True)
assert len(rows) > 0
bamf.close()
''' % str(tmp_path), tmp_path)


def test_reconstruct_cli_runs_without_jax(tmp_path):
    """The whole main path through the port's CLI, on the CPU."""
    _run(r'''
import os
from coral_tpu.sim import simulate_ecdna
from coral_tpu_torch.cli import main

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
