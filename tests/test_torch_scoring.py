"""The port's scoring module (``coral_tpu_torch.ops.scoring``) against the
JAX package's (``coral_tpu.ops.scoring``).

Inputs are made with numpy from a seed and go through both packages.
Tolerances: hit masks and support counts bit-exact; coverage exact int64.
"""
import math

import numpy as np
import pytest
import torch

from chip_smoke import synth_alignment_table, synth_scoring_batch
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
    assert all(c.dtype == torch.int32 for c in state.packed)
    bc, sc = ts.make_batch_scorer(state.int_chrom, state.int_start,
                                  state.int_end, engine="cuda",
                                  device="cpu")
    bt, st = ts.make_batch_scorer(ic, is_, ie, engine="torch", device="cpu")
    sup_c, cov_c = sc(bc(starts, ends), *state.packed)
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


def _pack6(cols):
    return ts.pack_pair_cols(*(np.asarray(cols[k]) for k in COL_ORDER
                               if not k.startswith("nm")))


def test_batch_scorer_cuda6_equals_jax_pallas6():
    """make_batch_scorer(engine='cuda6') on the 6 packed columns (CPU
    tensors: the wrapper's plain version) == the JAX package's fused
    6-column Pallas scorer in interpret mode: support bit-exact, coverage
    == combine_coverage(res, est) exactly; == the 'cuda' and 'torch'
    engines on the same batch."""
    import jax.numpy as jnp

    n = 1024
    starts, ends, cols, ic, is_, ie, packed3 = _batch(n=n, seed=13)
    packed6 = _pack6(cols)
    bp, sp = make_batch_scorer_jax(ic, is_, ie, engine="pallas6",
                                   interpret=True)
    sup_j, res, est = sp(bp(jnp.asarray(starts), jnp.asarray(ends)),
                         *[jnp.asarray(p) for p in packed6])
    b6, s6 = ts.make_batch_scorer(ic, is_, ie, engine="cuda6", device="cpu")
    sup, cov = s6(b6(starts, ends), *packed6)
    assert sup.dtype == torch.int32 and cov.dtype == torch.int64
    np.testing.assert_array_equal(sup.numpy(), np.asarray(sup_j))
    np.testing.assert_array_equal(cov.numpy(), combine_coverage(res, est))
    assert sup.sum() > 0
    b3, s3 = ts.make_batch_scorer(ic, is_, ie, engine="cuda", device="cpu")
    bt, st = ts.make_batch_scorer(ic, is_, ie, engine="torch", device="cpu")
    assert torch.equal(sup, s3(b3(starts, ends), *packed3)[0])
    assert torch.equal(sup, st(bt(starts, ends),
                               *[cols[k] for k in COL_ORDER])[0])


def test_batch_scorer_engines_past_the_v3_limit():
    """More than 8190 intervals: 'cuda' refuses and names 'cuda6'; 'cuda6'
    equals 'torch', also when the bounds are linear int64 coordinates whose
    low 32 bits are the chromosome's own."""
    n = 512
    starts, ends, cols, ic, is_, ie, _ = _batch(n=n, seed=17)
    span = np.int64(1) << 32
    far = np.arange(8190)
    ic_l = np.concatenate([ic, np.full(8190, 23, np.int32)])
    is_l = np.concatenate([is_.astype(np.int64), 150_000_000 + 1_000 * far])
    ie_l = np.concatenate([ie.astype(np.int64), 150_000_500 + 1_000 * far])
    with pytest.raises(ValueError, match="cuda6"):
        ts.make_batch_scorer(ic_l, is_l, ie_l, engine="cuda", device="cpu")
    with pytest.raises(ValueError, match="NM gate"):
        ts.make_batch_scorer(ic_l, is_l, ie_l, engine="cuda6", device="cpu",
                             max_nm=0.1)
    with pytest.raises(ValueError, match="unknown engine"):
        ts.make_batch_scorer(ic_l, is_l, ie_l, engine="pallas6",
                             device="cpu")
    lin_s, lin_e = is_l + ic_l * span, ie_l + ic_l * span
    lin_cols = dict(cols)
    for s in "ij":
        base = cols[f"chrom_{s}"].astype(np.int64) * span
        lin_cols[f"r1_{s}"] = cols[f"r1_{s}"] + base
        lin_cols[f"r2_{s}"] = cols[f"r2_{s}"] + base
    lin_reads = starts.astype(np.int64) + 3 * span, \
        ends.astype(np.int64) + 3 * span
    b6, s6 = ts.make_batch_scorer(ic_l, lin_s, lin_e, engine="cuda6",
                                  device="cpu")
    bt, st = ts.make_batch_scorer(ic_l, lin_s, lin_e, engine="torch",
                                  device="cpu")
    sup6, cov6 = s6(b6(*lin_reads), *_pack6(cols))
    supt, covt = st(bt(*lin_reads), *[lin_cols[k] for k in COL_ORDER])
    assert torch.equal(sup6, supt) and torch.equal(cov6, covt)
    assert sup6[:16].sum() > 0 and not sup6[16:].any()
    assert cov6[3] > 0 and not cov6[:3].any()


@pytest.mark.parametrize("n_int", [3, 8200])
def test_state_from_numpy_takes_both_layouts(n_int):
    starts, ends, cols, ic, is_, ie, packed3 = _batch(n=256, seed=2)
    ic, is_, ie = (np.resize(a, n_int) for a in (ic, is_, ie))
    s3 = ts.state_from_numpy(ic, is_, ie, packed3, device="cpu")
    s6 = ts.state_from_numpy(ic, is_, ie, _pack6(cols), device="cpu")
    assert len(s3.packed) == 3 and len(s6.packed) == 6
    assert s3.int_start.dtype == torch.int64
    assert s6.int_start.dtype == s6.int_end.dtype == torch.int32
    assert all(c.dtype == torch.int32 and c.is_contiguous()
               for c in s3.packed + s6.packed)
    with pytest.raises(ValueError, match="layout"):
        ts.state_from_numpy(ic, is_, ie, packed3[:2], device="cpu")


def test_host_half_equals_the_jax_package():
    """The numpy half of the port's scoring module against the JAX
    package's functions with ``xp=numpy``: constants, packers, unpackers and
    predicates, bit for bit."""
    from coral_tpu.ops import scoring as js

    for name in ("META_SIDE_BITS", "META_CHROM_SHIFT", "META_MAPQ_SHIFT",
                 "PACKED_COL_ORDER", "COL_ORDER", "META2_IOG_SHIFT",
                 "META2_MAPQ_I_SHIFT", "META2_STRAND_I_SHIFT",
                 "META2_MAPQ_J_SHIFT", "PACKED2_COL_ORDER",
                 "MAX_PACKED2_INTERVALS", "META3_IOG_SHIFT",
                 "PACKED3_COL_ORDER"):
        assert getattr(ts, name) == getattr(js, name), name
    rng = np.random.default_rng(8)
    cols = _minus_strand_cols(rng, 3000)
    cols["chrom_i"][:50] = -1                 # unknown chromosome
    ic = np.array([0, 1, 0], np.int32)
    is_ = np.array([1_000_000, 1_000_000, 1_200_000], np.int64)
    ie = np.array([1_200_000, 1_400_000, 1_400_000], np.int64)
    args14 = [cols[k] for k in COL_ORDER]
    for max_nm in (math.inf, 0.15):
        want = js.pair_predicate(np, *args14, ic, is_, ie, 100, 20, 100.0,
                                 max_nm)
        got = ts.pair_predicate_np(*args14, ic, is_, ie, 100, 20, 100.0,
                                   max_nm)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    args12 = [cols[k] for k in COL_ORDER if not k.startswith("nm")]
    packed = ts.pack_pair_cols(*args12)
    for a, b in zip(packed, js.pack_pair_cols(np, *args12)):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ts.unpack_pair_meta_np(packed[5]),
                    js.unpack_pair_meta(np, packed[5])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(
            ts.pair_predicate_packed_np(*packed, ic, is_, ie, 100, 20, 100.0),
            js.pair_predicate_packed(np, *packed, ic, is_, ie, 100, 20,
                                     100.0)):
        np.testing.assert_array_equal(a, b)
    table = synth_alignment_table(cols)
    for n_out in (None, 3072):
        for a, b in zip(ts.pack_pairs2_host(*table, ic, is_, ie, n_out=n_out),
                        js.pack_pairs2_host(*table, ic, is_, ie,
                                            n_out=n_out)):
            np.testing.assert_array_equal(a, b)
        p3 = ts.pack_pairs3_host(*table, ic, is_, ie, min_mapq=20,
                                 n_out=n_out)
        for a, b in zip(p3, js.pack_pairs3_host(*table, ic, is_, ie,
                                                min_mapq=20, n_out=n_out)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(ts.pair_predicate_packed3_np(*p3, 100, 100.0),
                    js.pair_predicate_packed3(np, *p3, 100, 100.0)):
        np.testing.assert_array_equal(a, b)


def test_packed6_tensor_predicate_equals_unpacked():
    """The tensor 6-column predicate (K3's plain version) == the 14-column
    tensor predicate with the NM gate off, with io_i ungated by side j."""
    rng = np.random.default_rng(31)
    cols = _minus_strand_cols(rng, 2048)
    cols["nm_i"] = cols["nm_j"] = np.zeros(2048, np.float32)
    cols = {k: (v if k.startswith("nm") else v.astype(np.int32))
            for k, v in cols.items()}
    ints = [torch.from_numpy(a) for a in (
        np.array([0, 1, 0], np.int32),
        np.array([1_000_000, 1_000_000, 1_200_000], np.int32),
        np.array([1_200_000, 1_400_000, 1_400_000], np.int32))]
    # MAPQ outside 0..255 clamps at pack time; clamp the unpacked side too
    for k in ("mapq_i", "mapq_j"):
        cols[k] = np.clip(cols[k], 0, 255)
    hit6, io6 = ts.pair_predicate_packed(
        *[torch.from_numpy(c) for c in _pack6(cols)], *ints, 100, 20, 100.0)
    hit14, io14 = ts.pair_predicate(*_t(cols), *ints, 100, 20, 100.0,
                                    math.inf)
    assert torch.equal(hit6, hit14) and torch.equal(io6, io14)
    assert hit6.any() and ((io6 >= 0) & ~hit6).any()
