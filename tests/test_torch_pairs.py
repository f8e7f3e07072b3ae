"""The port's pair scoring (``coral_tpu_torch.ops.pairs``) against the JAX
package's (``coral_tpu.ops.pairs``): hit masks bit-exact, breakpoint rows
and BpTable columns identical."""
import math

import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_chimeras
from coral_tpu.ops import pairs as jp
from coral_tpu_torch.ops import pairs as tp

CUTOFF, MIN_MAPQ, GAP = 100, 20, 100


@pytest.fixture(scope="module")
def chimeras():
    return _synthetic_chimeras(n_reads=7 * 60 + 3, seed=1)


def _table_with_nm(chims, seed=0):
    """The synthetic table with per-base NM spread over [0, 0.04) plus a
    few inf/NaN rows (degenerate 1-base alignments)."""
    table = tp.build_chimera_table(chims)
    rng = np.random.default_rng(seed)
    nm = (rng.random(table.n_alignments) * 0.04).astype(np.float32)
    nm[rng.integers(0, len(nm), 5)] = np.inf
    nm[rng.integers(0, len(nm), 5)] = np.nan
    table.nm = nm
    return table


@pytest.mark.parametrize("max_nm", [math.inf, 0.02])
def test_score_pairs_torch_equals_numpy_and_jax(chimeras, max_nm):
    chims, intervals = chimeras
    table = _table_with_nm(chims)
    _, _, want = jp.score_pairs_l(table, intervals, CUTOFF, MIN_MAPQ, GAP,
                                  max_nm, engine="numpy")
    _, _, want_jax = jp.score_pairs_l(table, intervals, CUTOFF, MIN_MAPQ,
                                      GAP, max_nm, engine="jax")
    pi, pj, got = tp.score_pairs_l(table, intervals, CUTOFF, MIN_MAPQ, GAP,
                                   max_nm, engine="torch", device="cpu")
    _, _, got_np = tp.score_pairs_l(table, intervals, CUTOFF, MIN_MAPQ, GAP,
                                    max_nm, engine="numpy", device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, want_jax)
    np.testing.assert_array_equal(got_np, want)
    np.testing.assert_array_equal(pj, pi + 1)
    assert 0 < want.sum() < len(want)


def test_score_pairs_small_batches(chimeras):
    """Batch boundaries of the host loop do not change the mask."""
    chims, intervals = chimeras
    table = tp.build_chimera_table(chims)
    _, _, want = tp.score_pairs_l(table, intervals, CUTOFF, MIN_MAPQ, GAP,
                                  engine="numpy", device="cpu")
    _, _, got = tp.score_pairs_l(table, intervals, CUTOFF, MIN_MAPQ, GAP,
                                 batch=37, engine="torch", device="cpu")
    np.testing.assert_array_equal(got, want)


def _cols(tb):
    return [np.asarray(getattr(tb, s)) for s in
            ("c1", "p1", "s1", "c2", "p2", "s2", "ridx", "ti", "tj",
             "rgap", "flip", "q1", "q2")]


@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_find_breakpoints_device_rows_and_table(chimeras, engine):
    """Rows and BpTable identical to the JAX package's, on the seven
    archetypes of the synthetic sample (rescue read included)."""
    chims, intervals = chimeras
    args = (chims, intervals, CUTOFF, MIN_MAPQ, GAP)
    rows = tp.find_breakpoints_device(*args, engine=engine, device="cpu")
    assert rows == jp.find_breakpoints_device(*args, engine="numpy")
    tb = tp.find_breakpoints_device(*args, engine=engine, as_table=True,
                                    device="cpu")
    tb_ref = jp.find_breakpoints_device(*args, engine="numpy",
                                        as_table=True)
    for a, b in zip(_cols(tb), _cols(tb_ref)):
        np.testing.assert_array_equal(a, b)
    assert tb.tup == tb_ref.tup and tb.rows() == tb_ref.rows() == rows
    assert len(tb.tup) > 0        # the rescue archetype took the slow path
    assert len(rows) >= 3 * (len(chims) // 7)


def test_cuda_engine_raises_without_cuda_and_past_v3_limit(chimeras):
    chims, intervals = chimeras
    table = tp.build_chimera_table(chims)
    with pytest.raises(ValueError, match="CUDA device"):
        tp.score_pairs_l(table, intervals, CUTOFF, MIN_MAPQ, GAP,
                         engine="cuda", device="cpu")
    many = intervals + [["chr1", 10 * k, 10 * k + 5, 0]
                        for k in range(8190)]
    with pytest.raises(NotImplementedError, match="K3"):
        tp.score_pairs_l(table, many, CUTOFF, MIN_MAPQ, GAP,
                         engine="cuda", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        tp.score_pairs_l(table, intervals, CUTOFF, MIN_MAPQ, GAP,
                         engine="jax", device="cpu")


def test_auto_routing():
    from coral_tpu.ops.routing import MIN_DEVICE_PAIRS

    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    assert tp.resolve_engine("auto", 10, gpu)[0] == "numpy"
    assert tp.resolve_engine("auto", MIN_DEVICE_PAIRS, cpu)[0] == "numpy"
    assert tp.resolve_engine("auto", MIN_DEVICE_PAIRS, gpu)[0] == "cuda"
    assert tp.resolve_engine("torch", 10, cpu) == ("torch", "forced")


def test_route_record(chimeras):
    chims, intervals = chimeras
    seq = tp.last_route_seq()
    tp.find_breakpoints_device(chims, intervals, CUTOFF, MIN_MAPQ, GAP,
                               engine="auto", device="cpu")
    (rec,) = tp.route_records_since(seq)
    assert rec.engine == "numpy" and rec.n_pairs > 0 and rec.seconds >= 0


def test_subset_to_bps_batch_equals_jax_without_flat_table(tmp_path,
                                                           monkeypatch):
    """The two-interval batch extractor on a native ChimeraStore: rows and
    table identical to the JAX package's, and the port never reaches
    ``ChimeraStore.flat_table`` (which imports coral_tpu.ops.pairs)."""
    from coral_tpu.io.bam import BamFile
    from coral_tpu.ops.chimera import ChimeraStore, collect_chimeras
    from coral_tpu.sim import simulate_ecdna

    bam_path, _, _ = simulate_ecdna(str(tmp_path), jitter=0)
    bam = BamFile(bam_path)
    _, store, _ = collect_chimeras(bam)
    assert isinstance(store, ChimeraStore)
    names = sorted(store.names)
    iv1, iv2 = ["chr7", 55_000_000, 55_200_000], \
        ["chr7", 55_200_000, 55_400_000]
    ref = jp.subset_to_bps_batch(store, names, iv1, iv2, CUTOFF, MIN_MAPQ)
    ref_tb = jp.subset_to_bps_batch(store, names, iv1, iv2, CUTOFF,
                                    MIN_MAPQ, as_table=True)
    store._table = None

    def no_flat_table(self):
        raise AssertionError("flat_table reached")

    monkeypatch.setattr(ChimeraStore, "flat_table", no_flat_table)
    got = tp.subset_to_bps_batch(store, names, iv1, iv2, CUTOFF, MIN_MAPQ)
    got_tb = tp.subset_to_bps_batch(store, names, iv1, iv2, CUTOFF,
                                    MIN_MAPQ, as_table=True)
    assert got == ref and len(got) > 0
    assert got_tb.rows() == ref_tb.rows() == got
    bam.close()
