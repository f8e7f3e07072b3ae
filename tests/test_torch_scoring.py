"""The port's scoring module (``coral_tpu_torch.ops.scoring``) against the
JAX package's (``coral_tpu.ops.scoring``).

Inputs are made with numpy from a seed and go through both packages.
Tolerances: hit masks and support counts bit-exact; coverage exact int64.
"""
import math

import numpy as np
import pytest
import torch

from bench import synth_alignment_table, synth_scoring_batch
from coral_tpu.ops.scoring import (COL_ORDER, combine_coverage,
                                   make_batch_scorer_jax,
                                   make_fused_step_numpy, pack_pairs3_host)
from coral_tpu.ops.scoring import pair_predicate as np_pair_predicate
from coral_tpu_torch.device import resolve_device
from coral_tpu_torch.ops import scoring as ts

N = 2048                  # 16 x 128 rows for the interpret-mode Pallas twin


def _batch(n=N, seed=5):
    """The benchmark's batch, with alignments moved into its 16 intervals
    (chrom k, [3e6 k, 3e6 k + 2e6]) so that many pairs hit."""
    starts, ends, cols, ic, is_, ie = synth_scoring_batch(n, seed=seed)
    rng = np.random.default_rng(seed)
    k = rng.integers(0, len(ic), n)
    for s in "ij":
        cols[f"chrom_{s}"] = ic[k]
        a = is_[k] + rng.integers(0, 1_900_000, n)
        cols[f"r1_{s}"] = a.astype(np.int32)
        cols[f"r2_{s}"] = (a + rng.integers(100, 100_000, n)).astype(np.int32)
    packed3 = pack_pairs3_host(*synth_alignment_table(cols), ic, is_, ie,
                               min_mapq=20)
    return starts, ends, cols, ic, is_, ie, packed3


def _t(cols):
    return [torch.from_numpy(np.ascontiguousarray(cols[k]))
            for k in COL_ORDER]


def test_batch_scorer_torch_equals_jax_pallas():
    """make_batch_scorer(engine='torch') on the 14 columns == the JAX
    package's fused Pallas scorer (interpret mode) on the v3 columns:
    support bit-exact, coverage == combine_coverage(res, est) exactly."""
    import jax.numpy as jnp

    starts, ends, cols, ic, is_, ie, packed3 = _batch()
    bp, sp = make_batch_scorer_jax(ic, is_, ie, engine="pallas",
                                   interpret=True)
    sup_j, res, est = sp(bp(jnp.asarray(starts), jnp.asarray(ends)),
                         *[jnp.asarray(p) for p in packed3])
    bt, st = ts.make_batch_scorer(ic, is_, ie, engine="torch", device="cpu")
    sup, cov = st(bt(starts, ends), *[cols[k] for k in COL_ORDER])
    assert sup.dtype == torch.int32 and cov.dtype == torch.int64
    np.testing.assert_array_equal(sup.numpy(), np.asarray(sup_j))
    np.testing.assert_array_equal(cov.numpy(), combine_coverage(res, est))
    assert sup.sum() > 0


def test_batch_scorer_cuda_engine_on_cpu_tensors():
    """The 'cuda' engine over the packed columns, run on CPU tensors (its
    wrapper's plain version), equals the 'torch' engine on the unpacked
    columns; state_from_numpy carries the JAX package's arrays over."""
    starts, ends, cols, ic, is_, ie, packed3 = _batch(seed=9)
    state = ts.state_from_numpy(ic, is_, ie, packed3, device="cpu")
    assert state.int_chrom.dtype == torch.int32
    assert state.int_start.dtype == torch.int64
    assert all(c.dtype == torch.int32 for c in state.packed3)
    bc, sc = ts.make_batch_scorer(state.int_chrom, state.int_start,
                                  state.int_end, engine="cuda",
                                  device="cpu")
    bt, st = ts.make_batch_scorer(ic, is_, ie, engine="torch", device="cpu")
    sup_c, cov_c = sc(bc(starts, ends), *state.packed3)
    sup_t, cov_t = st(bt(starts, ends), *[cols[k] for k in COL_ORDER])
    assert torch.equal(sup_c, sup_t)
    assert torch.equal(cov_c, cov_t)
    with pytest.raises(ValueError):
        ts.make_batch_scorer(ic, is_, ie, engine="cuda", device="cpu",
                             max_nm=0.1)


def test_coverage_int64_past_int32():
    """Per-interval aligned-base totals past 2^31 stay exact (the JAX
    package needs its residue/estimate pair for this; the port is int64)."""
    rng = np.random.default_rng(11)
    n = 1 << 20
    starts = rng.integers(0, 200_000_000, n).astype(np.int32)
    ends = (starts + rng.integers(1_000, 60_000, n)).astype(np.int32)
    ic = np.array([0, 1], np.int32)
    is_ = np.array([0, 50_000_000], np.int32)
    ie = np.array([200_000_000, 60_000_000], np.int32)
    zero = {k: np.zeros(8, np.float32 if k.startswith("nm") else np.int32)
            for k in COL_ORDER}
    _, cov_np = make_fused_step_numpy(ic, is_, ie)(
        starts, ends, *(zero[k] for k in COL_ORDER))
    build, score = ts.make_batch_scorer(ic, is_, ie, engine="torch",
                                        device="cpu")
    _, cov = score(build(starts, ends), *(zero[k] for k in COL_ORDER))
    assert int(cov[0]) > np.iinfo(np.int32).max
    np.testing.assert_array_equal(cov.numpy(), np.asarray(cov_np, np.int64))


def _minus_strand_cols(rng, n):
    """Pairs whose '-' strand rows store r1 > r2, straddling interval
    edges so the storage-order overlap test decides."""
    cols = {
        "qi_end": rng.integers(0, 9_000, n),
        "qj_start": rng.integers(0, 9_000, n),
        "chrom_i": rng.integers(0, 2, n), "chrom_j": rng.integers(0, 2, n),
        "strand_i": rng.choice([-1, 1], n), "strand_j": rng.choice([-1, 1], n),
        "mapq_i": rng.choice([-7, 0, 19, 20, 60, 255, 300, 999], n),
        "mapq_j": rng.choice([-1, 5, 20, 60, 256], n),
        "nm_i": (rng.random(n) * 0.3).astype(np.float32),
        "nm_j": (rng.random(n) * 0.3).astype(np.float32),
    }
    for s in "ij":
        a = rng.integers(990_000, 1_410_000, n)
        b = a + rng.integers(100, 20_000, n)
        minus = cols[f"strand_{s}"] < 0
        cols[f"r1_{s}"] = np.where(minus, b, a)
        cols[f"r2_{s}"] = np.where(minus, a, b)
    return {k: (v if k.startswith("nm") else v.astype(np.int64))
            for k, v in cols.items()}


@pytest.mark.parametrize("max_nm", [math.inf, 0.15])
@pytest.mark.parametrize("width", ["int64", "int32"])
def test_pair_predicate_minus_strand_mapq_nm(width, max_nm):
    """14-column predicate on tensors == numpy: '-' strand storage order,
    out-of-domain MAPQ, and the NM gate on and off."""
    rng = np.random.default_rng(21)
    cols = _minus_strand_cols(rng, 4096)
    if width == "int32":
        cols = {k: (v if k.startswith("nm") else v.astype(np.int32))
                for k, v in cols.items()}
    ic = np.array([0, 1, 0], np.int32)
    is_ = np.array([1_000_000, 1_000_000, 1_200_000], np.int64)
    ie = np.array([1_200_000, 1_400_000, 1_400_000], np.int64)
    want, io_want = np_pair_predicate(np, *(cols[k] for k in COL_ORDER),
                                      ic, is_, ie, 100, 20, 100.0, max_nm)
    got, io = ts.pair_predicate(*_t(cols), torch.from_numpy(ic),
                                torch.from_numpy(is_), torch.from_numpy(ie),
                                100, 20, 100.0, max_nm)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(io.numpy(), io_want)
    assert 0 < want.sum() < len(want)


def test_packed3_equals_unpacked_with_mapq_clamp_and_nm_gate_off():
    """The v3 route (MAPQ gate folded at pack time, no NM columns) equals
    the 14-column predicate fed the NM gate-off contract (zero nm,
    max_nm=inf) — including MAPQ values outside the BAM uint8 domain."""
    rng = np.random.default_rng(4)
    cols = _minus_strand_cols(rng, 2048)
    cols["nm_i"] = np.zeros(2048, np.float32)
    cols["nm_j"] = np.zeros(2048, np.float32)
    ic = np.array([0, 1], np.int32)
    is_ = np.array([1_000_000, 1_100_000], np.int64)
    ie = np.array([1_300_000, 1_400_000], np.int64)
    packed3 = pack_pairs3_host(*synth_alignment_table(cols), ic, is_, ie,
                               min_mapq=20)
    hit3, iogm = ts.pair_predicate_packed3(
        *[torch.from_numpy(c) for c in packed3], 100, 100.0)
    hit14, io = ts.pair_predicate(*_t(cols), torch.from_numpy(ic),
                                  torch.from_numpy(is_),
                                  torch.from_numpy(ie), 100, 20, 100.0,
                                  math.inf)
    assert torch.equal(hit3, hit14)
    assert torch.equal(iogm[hit3].long(), io[hit14])
    assert hit14.any()


def test_unpack_meta3_and_pad_rows():
    meta = torch.tensor([0, 1, (5 + 1) << 1, ((7 + 1) << 1) | 1],
                        dtype=torch.int32)
    iogm, sdiff = ts.unpack_pair_meta3(meta)
    assert iogm.tolist() == [-1, -1, 5, 7]
    assert sdiff.tolist() == [0, 1, 0, 1]
    zero = torch.zeros(4, dtype=torch.int32)
    hit, _ = ts.pair_predicate_packed3(zero, zero, meta, 100, 100.0)
    assert hit.tolist() == [False, False, False, True]


def test_resolve_device():
    assert ts.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
        with pytest.raises(RuntimeError):
            ts.make_batch_scorer([0], [0], [1], device="cuda")
