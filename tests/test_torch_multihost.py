"""The port's shard ingest (``coral_tpu_torch.parallel.multihost``): N
spawned processes each scan one contiguous shard of the BAM, and the
merged pipeline writes graph and cycles files byte-identical to the JAX
package's single-process run on the unsplit BAM."""
import dataclasses
import filecmp

import numpy as np
import pytest

from coral_tpu.config import DEFAULT_CONFIG
from coral_tpu.reconstruct import reconstruct_cycles as jax_cycles
from coral_tpu.reconstruct import reconstruct_graphs as jax_graphs
from coral_tpu_torch.io.bam import BamFile
from coral_tpu_torch.parallel.multihost import (
    MultiShardBam,
    merge_scan_products,
    multihost_reconstruct_graphs,
    scan_shard,
    split_bam,
)
from coral_tpu_torch.reconstruct import reconstruct_cycles
from coral_tpu_torch.sim import simulate_mixed_sample


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    """The mixed sample and the JAX package's single-process outputs, with
    its numpy CN engine (the port's ``auto`` below 32 amplicons)."""
    out = tmp_path_factory.mktemp("tmh")
    bam, cns, seeds = simulate_mixed_sample(str(out))
    prefix = str(out / "single")
    cfg = DEFAULT_CONFIG.replace(engine=dataclasses.replace(
        DEFAULT_CONFIG.engine, cn_engine="numpy"))
    rec = jax_graphs(bam, seeds, cns, prefix, cfg=cfg)
    jax_cycles(rec, prefix)
    rec.bam.close()
    return out, bam, cns, seeds, len(rec.graphs)


def test_split_and_merge_equal_the_unsplit_bam(sample, tmp_path):
    """Shards concatenate to the BAM; the shard view's reductions and the
    merged scan products equal the unsplit file's."""
    from coral_tpu_torch.ops.chimera import collect_chimeras

    _, bam, _, _, _ = sample
    shards = split_bam(bam, [str(tmp_path / f"s{i}.bam") for i in range(3)])
    whole = BamFile(bam)
    view = MultiShardBam(shards)
    np.testing.assert_array_equal(view.pos, np.asarray(whole.pos))
    np.testing.assert_array_equal(view.end, np.asarray(whole.end))
    region = ("chr7", 55_000_000, 55_100_000)
    assert view.coverage_sum(*region) == whole.coverage_sum(*region)
    assert view.read_count(*region) == whole.read_count(*region)
    assert view.names_overlapping(*region) == whole.names_overlapping(*region)
    read_length, chimeras, nm_stats = merge_scan_products(
        [scan_shard(p) for p in shards], shards=view.shards)
    wl, wc, wn = collect_chimeras(whole)
    assert list(chimeras) == list(wc)
    for rn in chimeras:
        assert (chimeras[rn].q, chimeras[rn].r, chimeras[rn].mapq) \
            == (wc[rn].q, wc[rn].r, wc[rn].mapq)
    assert nm_stats[2] == wn[2]
    view.close()
    whole.close()


@pytest.mark.parametrize("n_shards", [2, 3])
def test_multiprocess_outputs_equal_the_jax_single_process_run(
        sample, tmp_path, n_shards):
    out, bam, cns, seeds, n_amp = sample
    shards = split_bam(
        bam, [str(tmp_path / f"n{n_shards}_s{i}.bam")
              for i in range(n_shards)])
    prefix = str(tmp_path / f"multi{n_shards}")
    rec = multihost_reconstruct_graphs(shards, seeds, cns, prefix,
                                       device="cpu")
    reconstruct_cycles(rec, prefix)
    rec.bam.close()
    assert len(rec.graphs) == n_amp >= 2
    for gi in range(1, n_amp + 1):
        for kind in ("graph", "cycles"):
            want = str(out / f"single_amplicon{gi}_{kind}.txt")
            got = f"{prefix}_amplicon{gi}_{kind}.txt"
            assert filecmp.cmp(want, got, shallow=False), \
                f"{kind} differs for amplicon {gi} at {n_shards} shards"
