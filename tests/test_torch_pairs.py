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
    # past the v3 limit the cuda engine goes to K3: no longer refused for
    # the interval count, only for the device
    with pytest.raises(ValueError, match="CUDA device"):
        tp.score_pairs_l(table, many, CUTOFF, MIN_MAPQ, GAP,
                         engine="cuda", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        tp.score_pairs_l(table, intervals, CUTOFF, MIN_MAPQ, GAP,
                         engine="jax", device="cpu")


def test_auto_routing():
    from coral_tpu.ops.routing import MIN_DEVICE_PAIRS

    assert tp.MIN_DEVICE_PAIRS == MIN_DEVICE_PAIRS
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
    """The two-interval batch extractor on a native ChimeraStore, each
    package on its own scan of the same BAM: rows and table identical to
    the JAX package's, and the port never reaches the JAX package's
    ``ChimeraStore.flat_table`` (which imports coral_tpu.ops.pairs)."""
    from coral_tpu.io.bam import BamFile
    from coral_tpu.ops.chimera import ChimeraStore, collect_chimeras
    from coral_tpu.sim import simulate_ecdna
    from coral_tpu_torch.io.bam import BamFile as PortBamFile
    from coral_tpu_torch.ops import chimera as port_chimera

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

    def no_flat_table(self):
        raise AssertionError("flat_table reached")

    monkeypatch.setattr(ChimeraStore, "flat_table", no_flat_table)
    port_bam = PortBamFile(bam_path)
    _, port_store, _ = port_chimera.collect_chimeras(port_bam)
    assert isinstance(port_store, port_chimera.ChimeraStore)
    assert sorted(port_store.names) == names
    got = tp.subset_to_bps_batch(port_store, names, iv1, iv2, CUTOFF,
                                 MIN_MAPQ)
    got_tb = tp.subset_to_bps_batch(port_store, names, iv1, iv2, CUTOFF,
                                    MIN_MAPQ, as_table=True)
    assert got == ref and len(got) > 0
    assert got_tb.rows() == ref_tb.rows() == got
    bam.close()
    port_bam.close()


def _long_list(intervals, first: bool):
    """The two real intervals plus 8,190 decoys that overlap no read, so
    the list is past the v3 layout's limit."""
    decoys = [["chr1", 1_000 * k, 1_000 * k + 500, 0] for k in range(8190)]
    return decoys + intervals if first else intervals + decoys


@pytest.mark.parametrize("first", [False, True], ids=["decoys-last",
                                                      "decoys-first"])
def test_score_pairs_past_the_v3_limit(chimeras, first):
    """More than 8190 intervals: the torch and numpy engines and the
    6-column route (native pack + K3's wrapper, on CPU tensors its plain
    version) against the JAX package's numpy engine; the decoys move the
    interval indices, not the hits."""
    chims, intervals = chimeras
    many = _long_list(intervals, first)
    assert len(many) > tp.MAX_PACKED2_INTERVALS
    table = tp.build_chimera_table(chims)
    _, _, want = jp.score_pairs_l(table, many, CUTOFF, MIN_MAPQ, GAP,
                                  engine="numpy")
    _, _, short = jp.score_pairs_l(table, intervals, CUTOFF, MIN_MAPQ, GAP,
                                   engine="numpy")
    np.testing.assert_array_equal(want, short)
    for engine in ("numpy", "torch"):
        pi, _, got = tp.score_pairs_l(table, many, CUTOFF, MIN_MAPQ, GAP,
                                      engine=engine, device="cpu")
        np.testing.assert_array_equal(got, want)
    ic = np.asarray([tp.CHR_IDX.get(iv[0], -2) for iv in many], np.int32)
    is_ = np.asarray([iv[1] for iv in many], np.int64)
    ie = np.asarray([iv[2] for iv in many], np.int64)
    got6 = tp._hitmask_6col(table, pi, ic, is_, ie, CUTOFF, MIN_MAPQ,
                            float(GAP), torch.device("cpu"))
    np.testing.assert_array_equal(got6, want)
    got3 = tp._hitmask_v3(table, pi, ic[:8190] if first else ic[:2],
                          is_[:8190] if first else is_[:2],
                          ie[:8190] if first else ie[:2], CUTOFF, MIN_MAPQ,
                          float(GAP), torch.device("cpu"))
    if not first:
        np.testing.assert_array_equal(got3, want)
    else:
        assert not got3.any()         # decoys alone: nothing hits
    assert 0 < want.sum() < len(want)


def test_find_breakpoints_past_the_v3_limit(chimeras):
    """Rows and BpTable over the long list == the JAX package's (the
    rescue read goes through the per-read path over all 8,192 intervals)."""
    chims, intervals = chimeras
    many = _long_list(intervals, first=False)
    args = (chims, many, CUTOFF, MIN_MAPQ, GAP)
    tb = tp.find_breakpoints_device(*args, engine="torch", as_table=True,
                                    device="cpu")
    tb_ref = jp.find_breakpoints_device(*args, engine="numpy", as_table=True)
    for a, b in zip(_cols(tb), _cols(tb_ref)):
        np.testing.assert_array_equal(a, b)
    assert tb.tup == tb_ref.tup and len(tb.tup) > 0


def test_native_packers_equal_host_twins(chimeras):
    """The packers of the library the port builds itself against their
    numpy twins, bit for bit, zero padding included."""
    from coral_tpu_torch.native import _build, bamcore
    from coral_tpu_torch.ops import scoring as ts

    lib = bamcore._load()
    assert lib._name == str(_build.library_path("bamcore"))
    assert "coral_tpu_torch" in lib._name and "/coral_tpu/" not in lib._name
    chims, intervals = chimeras
    table = tp.build_chimera_table(chims)
    rng = np.random.default_rng(3)
    table.mapq = table.mapq.copy()
    table.mapq[rng.integers(0, len(table.mapq), 9)] = [-4, 0, 19, 20, 255,
                                                      256, 300, 999, 21]
    pi, pj = tp.adjacent_pair_indices(table.read_off)
    flat = (pi, table.q_start, table.q_end, table.r1, table.r2, table.chrom,
            table.strand, table.mapq)
    ic = np.asarray([tp.CHR_IDX[iv[0]] for iv in intervals], np.int32)
    is_ = np.asarray([iv[1] for iv in intervals], np.int64)
    ie = np.asarray([iv[2] for iv in intervals], np.int64)
    n_out = len(pi) + 77
    want6 = ts.pack_pair_cols(
        table.q_end[pi], table.q_start[pj], table.chrom[pi], table.r1[pi],
        table.r2[pi], table.strand[pi].astype(np.int32), table.mapq[pi],
        table.chrom[pj], table.r1[pj], table.r2[pj],
        table.strand[pj].astype(np.int32), table.mapq[pj])
    for got, want in zip(bamcore.pack_pairs(*flat, n_out=n_out), want6):
        assert got.dtype == np.int32 and len(got) == n_out
        np.testing.assert_array_equal(got[:len(pi)], want)
        assert not got[len(pi):].any()
    for got, want in zip(
            bamcore.pack_pairs2(*flat, ic, is_, ie, n_out=n_out),
            ts.pack_pairs2_host(*flat, ic, is_, ie, n_out=n_out)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(
            bamcore.pack_pairs3(*flat, ic, is_, ie, min_mapq=20, n_out=n_out),
            ts.pack_pairs3_host(*flat, ic, is_, ie, min_mapq=20,
                                n_out=n_out)):
        np.testing.assert_array_equal(got, want)


def test_cluster_breakpoints_device_engine_is_not_ported():
    """The name dates from before K9 (the match-matrix kernel) was ported;
    what it holds now: ``engine="cuda"`` raises without a card instead of
    clustering on the host, and an engine that does not exist (the JAX
    package's ``pallas`` included) raises ``ValueError``."""
    import torch

    from coral_tpu_torch.ops.breakpoints import cluster_breakpoints

    bps = [["chr1", 100 + k, "+", "chr1", 900 + k, "-", ("r", 0, 1), 0, 0,
            60, 60] for k in range(4)]
    assert len(cluster_breakpoints(bps, 2, 50)) == 1
    for engine in ("pallas", "numpy", ""):
        with pytest.raises(ValueError, match="unknown engine"):
            cluster_breakpoints(bps, 2, 50, engine=engine)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cluster_breakpoints(bps, 2, 50, engine="cuda")
        with pytest.raises(RuntimeError, match="cuda"):
            cluster_breakpoints(bps, 2, 50, engine="torch", device="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        cluster_breakpoints(bps, 2, 50, engine="cuda", device="cpu")
