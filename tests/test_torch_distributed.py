"""The port's multi-process layer (``coral_tpu_torch.parallel.distributed``)
in real ``torch.distributed`` groups: gloo, a ``file://`` rendezvous under
the test's directory, one spawned process per BAM shard.  Every process
must produce the histogram of the unsplit BAM and write the JAX package's
single-process outputs byte for byte."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from coral_tpu.config import DEFAULT_CONFIG
from coral_tpu.ops.coverage import CoverageIndex
from coral_tpu.reconstruct import reconstruct_cycles, reconstruct_graphs
from coral_tpu_torch.io.bam import BamFile
from coral_tpu_torch.parallel import distributed
from coral_tpu_torch.parallel.multihost import split_bam
from coral_tpu_torch.sim import simulate_ecdna

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHROM, ORIGIN, BIN, NBINS = "chr7", 54_000_000, 100_000, 64


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    """The sample, its chr7 histogram, and the JAX package's single-process
    outputs (numpy CN engine, the port's ``auto`` below 32 amplicons)."""
    out = tmp_path_factory.mktemp("tdist")
    bam, cns, seeds = simulate_ecdna(str(out), jitter=2)
    whole = BamFile(bam)
    s, e = whole._ref_slices[whole.rid(CHROM)]
    expect = np.asarray(CoverageIndex(whole.pos[s:e], whole.end[s:e])
                        .bin_histogram(ORIGIN, BIN, NBINS), np.int64)
    whole.close()
    assert expect.sum() > 0
    cfg = DEFAULT_CONFIG.replace(engine=dataclasses.replace(
        DEFAULT_CONFIG.engine, cn_engine="numpy"))
    rec = reconstruct_graphs(bam, seeds, cns, str(out / "single"), cfg=cfg)
    reconstruct_cycles(rec, str(out / "single"))
    rec.bam.close()
    single = {f[len("single"):]: (out / f).read_bytes()
              for f in os.listdir(out)
              if f.startswith("single_") and f.endswith(".txt")}
    assert any(k.endswith("_cycles.txt") for k in single)
    return bam, cns, seeds, expect, single


def _run_group(argv_of_rank, nproc: int, tmp_path, timeout=300):
    """One process a rank, ``python <argv_of_rank(rank)>``; every process
    must exit 0 within ``timeout`` s (all are killed otherwise).  Returns
    their standard outputs."""
    env = dict(os.environ, PYTHONPATH=ROOT, TMPDIR=str(tmp_path))
    procs = [subprocess.Popen([sys.executable, *argv_of_rank(r)], env=env,
                              cwd=str(tmp_path), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(nproc)]
    outs = []
    try:
        for p in procs:
            sout, serr = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank failed:\n{sout}\n{serr[-4000:]}"
            outs.append(sout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _worker(*args):
    return ["-m", "coral_tpu_torch.parallel.distributed", *map(str, args)]


@pytest.mark.parametrize("nproc", [2, 3])
def test_shard_bin_histogram_matches_single_process(sample, tmp_path, nproc):
    bam, _, _, expect, _ = sample
    shards = split_bam(bam, [str(tmp_path / f"s{i}.bam")
                             for i in range(nproc)])
    rdzv = f"file://{tmp_path / 'rdzv'}"
    _run_group(lambda r: _worker(
        r, nproc, rdzv, "gloo", "cpu", shards[r], CHROM, ORIGIN, BIN, NBINS,
        tmp_path / f"hist{r}.npy"), nproc, tmp_path)
    for r in range(nproc):
        hist = np.load(tmp_path / f"hist{r}.npy")
        assert hist.dtype == np.int64
        np.testing.assert_array_equal(hist, expect)


@pytest.mark.parametrize("nproc", [2, 3])
def test_distributed_pipeline_byte_identical(sample, tmp_path, nproc):
    """The whole reconstruct (graphs and cycles) in an N-process group:
    pair scoring sharded over the global mesh and gathered, coverage
    summed across processes; every process's files equal the JAX
    package's single-process run."""
    bam, cns, seeds, _, single = sample
    shards = split_bam(bam, [str(tmp_path / f"ps{i}.bam")
                             for i in range(nproc)])
    rdzv = f"file://{tmp_path / 'rdzv'}"
    prefix = tmp_path / "dist"
    outs = _run_group(lambda r: _worker(
        "pipeline", r, nproc, rdzv, "gloo", "cpu", seeds, cns, prefix,
        *shards), nproc, tmp_path)
    assert all("graphs=" in o for o in outs)
    for r in range(nproc):
        got = {f[len(f"dist.p{r}"):]: (tmp_path / f).read_bytes()
               for f in os.listdir(tmp_path)
               if f.startswith(f"dist.p{r}_") and f.endswith(".txt")}
        assert got == single, (
            f"rank {r}: {sorted(set(single) ^ set(got)) or 'content differs'}")


PRIMITIVES = r'''
import json, sys
import numpy as np
from coral_tpu_torch.parallel import distributed as d
rank, world, rdzv = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
d.initialize(rdzv, world, rank, backend="gloo", device="cpu")
total = d.allreduce_sum(np.array([2**40 + rank, -rank], np.int64))
parts = d.allgather_bytes(b"r%d" % rank * rank)
mesh = d.global_mesh()
print(json.dumps({"total": total.tolist(), "dtype": str(total.dtype),
                  "parts": [p.decode() for p in parts],
                  "shape": mesh.shape, "ranks": mesh.ranks.tolist(),
                  "devices": [str(x) for x in mesh.devices.flat]}))
import torch.distributed as dist
dist.destroy_process_group()
'''


def test_collectives_sum_in_int64_and_gather_in_process_order(tmp_path):
    """allreduce_sum past int32, allgather_bytes in rank order (rank 0's
    payload empty) and the global mesh, in a 3-process group."""
    rdzv = f"file://{tmp_path / 'rdzv'}"
    outs = _run_group(lambda r: ["-c", PRIMITIVES, str(r), "3", rdzv], 3,
                      tmp_path)
    for out in outs:
        got = json.loads(out.strip().splitlines()[-1])
        assert got["total"] == [3 * 2**40 + 3, -3]
        assert got["dtype"] == "int64"
        assert got["parts"] == ["", "r1", "r2r2"]
        assert got["shape"] == {"dp": 3} and got["ranks"] == [0, 1, 2]
        assert got["devices"] == ["cpu"] * 3


def test_backends_are_explicit(tmp_path):
    """No silent switch: an unknown backend and nccl off a card raise
    before any group exists; two ranks on one card raise."""
    rdzv = f"file://{tmp_path / 'rdzv'}"
    with pytest.raises(ValueError, match="unknown backend"):
        distributed.initialize(rdzv, 1, 0, backend="mpi", device="cpu")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        distributed.initialize(rdzv, 1, 0, backend="nccl", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            distributed.initialize(rdzv, 1, 0, backend="nccl",
                                   device="cuda")
    with pytest.raises(RuntimeError, match="ranks 0 and 2"):
        distributed.check_one_card_per_rank(["h/a", "h/b", "h/a"])
    distributed.check_one_card_per_rank(["h/a", "h/b", "g/a"])
    with pytest.raises(RuntimeError, match="initialize"):
        distributed.local_device()
    assert not torch.distributed.is_initialized()
