"""K5 and K6 of the port (``coral_tpu_torch.ops.kernels``) against the
Pallas kernels they replace, and the v2 layout's functions and the
``cuda2`` batch scorer against their JAX counterparts.

On the CPU the wrappers run their plain PyTorch versions, which are held
here against ``pair_predicates_pallas_packed2`` and
``make_pair_hist2_pallas_fn`` in interpret mode (and numpy), bit for bit:
masks, gate indices and counts are integers, so the tolerance is zero.
The CUDA kernels themselves are held against the plain versions by the
tests marked ``cuda`` (skipped without a card) and by ``chip_smoke.py``.
This module imports JAX only inside the tests that need it, so that on a
machine with a card and no JAX
``python -m pytest --noconftest tests/test_torch_kernels2.py -m cuda``
runs the card tests.
"""
import numpy as np
import pytest
import torch

from coral_tpu_torch.ops import kernels
from coral_tpu_torch.ops import scoring as ts
from coral_tpu_torch.ops.layout import LANES, _bucket_rows

CUTOFF = 100
MIN_MAPQ = 20
GAP = 100.0
ROWS = 16                 # 16 x 128 pairs: interpret-mode Pallas stays fast
N = ROWS * LANES
N_INT = 16
KINDS = ["native", "dense", "edge", "pad", "mapq", "wrap"]


def _alignments(seed: int, n_aln: int):
    """A flat ALIGNMENT table in the manner of
    ``tests/test_pallas_kernels.py``: MAPQ over the clamp domain, unknown
    chromosomes, both strands."""
    rng = np.random.default_rng(seed)
    qs = rng.integers(0, 30_000, n_aln).astype(np.int64)
    qe = rng.integers(0, 30_000, n_aln).astype(np.int64)
    r1 = rng.integers(0, 3_000_000, n_aln).astype(np.int64)
    r2 = rng.integers(0, 3_000_000, n_aln).astype(np.int64)
    chrom = rng.integers(-1, 4, n_aln).astype(np.int32)
    strand = rng.choice([-1, 1], n_aln).astype(np.int8)
    mapq = rng.integers(-2, 300, n_aln).astype(np.int32)
    pi = np.flatnonzero(rng.random(n_aln - 1) < 0.8).astype(np.int64)
    ic = np.asarray([0, 1, 2, 0], np.int32)
    is_ = np.asarray([0, 100_000, 500_000, 2_000_000], np.int64)
    ie = np.asarray([1_500_000, 2_000_000, 2_500_000, 2_900_000], np.int64)
    return (pi, qs, qe, r1, r2, chrom, strand, mapq), (ic, is_, ie)


def _case(kind: str, n: int = N, n_int: int = N_INT, seed: int = 0):
    """Packed v2 columns (qgap, r2_i, r1_j, meta), int32, ``n`` rows, and
    the number of live rows.

    native: the native ``pack_pairs2`` of a random alignment table over 4
    intervals, zero-padded to ``n``; dense: about two thirds of the rows hit;
    edge: same strand, |qgap| a multiple of 5 with the reference jump
    |qgap|/5 and +-1 away, and qgap = -cutoff and -cutoff-1; pad: zero rows
    among live ones; mapq: both MAPQs drawn around the gate (19, 20, 21)
    and at the ends of the byte; wrap: ends of int32 in every column, where
    the int32 arithmetic of the TPU kernel wraps."""
    rng = np.random.default_rng(seed)
    if kind == "native":
        from coral_tpu_torch.native.bamcore import pack_pairs2

        table, ints = _alignments(seed + 17, n - n // 4)
        assert _bucket_rows(len(table[0])) * LANES == n
        return pack_pairs2(*table, *ints, n_out=n, nthreads=3), len(table[0])
    qgap = rng.integers(-300, 60_000, n).astype(np.int64)
    r2_i = rng.integers(0, 200_000_000, n).astype(np.int64)
    si = rng.choice([-1, 1], n)
    sj = rng.choice([-1, 1], n)
    jump = qgap + rng.integers(-30_000, 30_000, n)
    iog = rng.integers(-n_int // 3, n_int, n)
    mapqs, weights = [0, 5, 19, 20, 21, 60, 255], \
        [.02, .03, .05, .1, .1, .65, .05]
    mi = rng.choice(mapqs, n, p=weights)
    mj = rng.choice(mapqs, n, p=weights)
    if kind == "edge":
        q = 5 * rng.integers(101, 12_000, n) * rng.choice([-1, 1], n)
        qgap = q
        jump = q - np.sign(q) * (np.abs(q) // 5 + rng.integers(-1, 2, n)) \
            * rng.choice([-1, 1], n)
        si[:] = sj
        iog = rng.integers(0, n_int, n)
        mi[:] = mj[:] = 60
        k = n // 4
        qgap[:k] = -CUTOFF - rng.integers(0, 2, k)
        si[:k] = -sj[:k]
    elif kind == "mapq":
        mi = rng.choice([0, 19, 20, 21, 255], n)
        mj = rng.choice([0, 19, 20, 21, 255], n)
        iog = rng.integers(0, n_int, n)
    # the jump is r1_j - r2_i on a '+' side j, r2_i - r1_j on a '-' one
    r1_j = np.where(sj > 0, r2_i + jump, r2_i - jump)
    if kind == "wrap":
        ext = np.array([-2**31, -2**31 + 1, -2**31 + 99, 2**31 - 1,
                        2**31 - 100, 2**31 - 101, -1, 0], np.int64)
        qgap, r2_i, r1_j = (rng.choice(ext, n) for _ in range(3))
        mi[:] = mj[:] = 60
    cols = list(ts.pack_pair_cols2(np.zeros(n, np.int64), qgap, r2_i, si, mi,
                                   r1_j, sj, mj, iog))
    if kind == "pad":
        dead = rng.random(n) < 0.3
        for c in cols:
            c[dead] = 0
    return cols, n


def _cpu(cols):
    return [torch.from_numpy(np.ascontiguousarray(c)) for c in cols]


@pytest.mark.parametrize("kind", KINDS)
def test_hitmask_plain_equals_pallas(kind):
    from coral_tpu.ops.pallas_kernels import pair_predicates_pallas_packed2

    packed, n = _case(kind)
    want_hit, want_iog = pair_predicates_pallas_packed2(
        packed, n, CUTOFF, MIN_MAPQ, GAP, interpret=True)
    hit, iog = kernels.pair2_hitmask(*_cpu(packed), CUTOFF, MIN_MAPQ, GAP)
    assert hit.dtype == torch.bool and iog.dtype == torch.int32
    np.testing.assert_array_equal(hit.numpy()[:n], want_hit)
    np.testing.assert_array_equal(iog.numpy()[:n], want_iog)
    assert not hit.numpy()[n:].any() and (iog.numpy()[n:] == -1).all()
    got = kernels.pair_predicates_packed2(packed, n, CUTOFF, MIN_MAPQ, GAP,
                                          device="cpu")
    np.testing.assert_array_equal(got[0], want_hit)
    np.testing.assert_array_equal(got[1], want_iog)
    if kind != "wrap":
        # numpy's threshold is float64; it agrees wherever |qgap| < 2^24
        hit_np, iog_np = ts.pair_predicate_packed2_np(*packed, CUTOFF,
                                                      MIN_MAPQ, GAP)
        np.testing.assert_array_equal(hit.numpy(), hit_np)
        np.testing.assert_array_equal(iog.numpy(), iog_np)
    assert want_hit.any() and not want_hit.all()
    if kind == "dense":
        assert 0.4 < want_hit.mean() < 0.8
    if kind == "mapq":
        # iog is not gated by MAPQ: pairs below the gate keep their index
        _, _, mi, _, mj = ts.unpack_pair_meta2_np(packed[3])
        low = (mi < MIN_MAPQ) | (mj < MIN_MAPQ)
        assert low.any() and (want_iog[low] >= 0).all()
        assert not want_hit[low].any()
        assert want_hit[(mi == MIN_MAPQ) & (mj == MIN_MAPQ)].any()


@pytest.mark.parametrize("n_int", [1, N_INT])
@pytest.mark.parametrize("kind", KINDS)
def test_support_plain_equals_pallas(kind, n_int):
    from coral_tpu.ops.pallas_kernels import make_pair_hist2_pallas_fn

    packed, _ = _case(kind)
    fn = make_pair_hist2_pallas_fn(ROWS, n_int, CUTOFF, MIN_MAPQ, GAP,
                                   interpret=True)
    want = np.asarray(fn(*[c.reshape(ROWS, LANES) for c in packed]))[0]
    got = kernels.pair2_support(*_cpu(packed), n_int, CUTOFF, MIN_MAPQ, GAP)
    assert got.dtype == torch.int32 and got.shape == (n_int,)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind in ("dense", "native"):
        assert want.sum() > 0


def test_v2_equals_v3_on_the_same_pairs():
    """v2 and v3 are one predicate: K5's hit mask equals K1's and K6's
    support equals K2's on an alignment table packed both ways, and the
    gates differ only by the MAPQ gate."""
    table, ints = _alignments(5, 3000)
    p2 = ts.pack_pairs2_host(*table, *ints)
    p3 = ts.pack_pairs3_host(*table, *ints, min_mapq=MIN_MAPQ)
    hit2, iog = kernels.pair2_hitmask(*_cpu(p2), CUTOFF, MIN_MAPQ, GAP)
    hit3 = kernels.pair3_hitmask(*_cpu(p3), CUTOFF, GAP)
    assert torch.equal(hit2, hit3) and hit2.any()
    iogm = ts.unpack_pair_meta3(p3[2])[0]
    _, _, mi, _, mj = ts.unpack_pair_meta2_np(p2[3])
    ok = (mi >= MIN_MAPQ) & (mj >= MIN_MAPQ)
    np.testing.assert_array_equal(np.where(ok, iog.numpy(), -1), iogm)
    assert torch.equal(
        kernels.pair2_support(*_cpu(p2), 4, CUTOFF, MIN_MAPQ, GAP),
        kernels.pair3_support(*_cpu(p3), 4, CUTOFF, GAP))


def test_support_max_intervals_equals_bincount():
    """n_int = 8190 (the layout's limit) on a few rows, against numpy: the
    Pallas kernel unrolls one loop step per bin, too slow to trace at this
    width in interpret mode.  A float MAPQ gate rounds up."""
    n_int = 8190
    packed, _ = _case("dense", n=64, n_int=n_int, seed=3)
    packed[3][:4] = ((np.array([0, 8189, 8189, 17]) + 1) << 18) \
        | (60 << 10) | (60 << 1) | 1
    packed[0][:4] = 0
    got = kernels.pair2_support(*_cpu(packed), n_int, CUTOFF, 19.5, GAP)
    hit, iog = ts.pair_predicate_packed2_np(*packed, CUTOFF, MIN_MAPQ, GAP)
    np.testing.assert_array_equal(
        got.numpy(), np.bincount(iog[hit], minlength=n_int))
    assert got[8189] >= 2


def test_v2_host_half_equals_the_jax_package():
    """``pack_pair_cols2``, the meta2 unpackers and the numpy and tensor
    predicates over the v2 layout against the JAX package's functions with
    ``xp=numpy``, bit for bit."""
    from coral_tpu.ops import scoring as js

    rng = np.random.default_rng(4)
    n = 3000
    args = (rng.integers(0, 30_000, n), rng.integers(0, 30_000, n),
            rng.integers(0, 3_000_000, n), rng.choice([-1, 1], n),
            rng.integers(-2, 300, n), rng.integers(0, 3_000_000, n),
            rng.choice([-1, 1], n), rng.integers(-2, 300, n),
            rng.integers(-1, 8190, n))
    packed = ts.pack_pair_cols2(*args)
    for a, b in zip(packed, js.pack_pair_cols2(np, *args)):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    want = js.unpack_pair_meta2(np, packed[3])
    for a, b in zip(ts.unpack_pair_meta2_np(packed[3]), want):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ts.unpack_pair_meta2(torch.from_numpy(packed[3])), want):
        np.testing.assert_array_equal(a.numpy(), b)
    want = js.pair_predicate_packed2(np, *packed, CUTOFF, MIN_MAPQ, GAP)
    for a, b in zip(ts.pair_predicate_packed2_np(*packed, CUTOFF, MIN_MAPQ,
                                                 GAP), want):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ts.pair_predicate_packed2(*_cpu(packed), CUTOFF,
                                              MIN_MAPQ, GAP), want):
        np.testing.assert_array_equal(a.numpy(), b)
    assert want[0].any()


def test_batch_scorer_cuda2_equals_jax_pallas2():
    """make_batch_scorer(engine='cuda2') on the 4 packed columns (CPU
    tensors: the wrapper's plain version) == the JAX package's fused v2
    Pallas scorer in interpret mode: support bit-exact, coverage ==
    combine_coverage(res, est) exactly; == the 'cuda' engine on the same
    pairs packed to v3."""
    import jax.numpy as jnp

    from chip_smoke import synth_scoring_batch
    from coral_tpu.ops.scoring import combine_coverage, make_batch_scorer_jax

    starts, ends, _, _, _, _ = synth_scoring_batch(4096, seed=5)
    table, (ic, is_, ie) = _alignments(29, N - N // 4)
    n = len(table[0])
    packed2 = ts.pack_pairs2_host(*table, ic, is_, ie, n_out=N)
    packed3 = ts.pack_pairs3_host(*table, ic, is_, ie, min_mapq=MIN_MAPQ,
                                  n_out=N)
    bp, sp = make_batch_scorer_jax(ic, is_.astype(np.int32),
                                   ie.astype(np.int32), engine="pallas2",
                                   interpret=True)
    sup_j, res, est = sp(bp(jnp.asarray(starts), jnp.asarray(ends)),
                         *[jnp.asarray(p) for p in packed2])
    st2 = ts.state_from_numpy(ic, is_, ie, packed2, device="cpu")
    assert len(st2.packed) == 4 and st2.int_start.dtype == torch.int64
    b2, s2 = ts.make_batch_scorer(ic, is_, ie, engine="cuda2", device="cpu")
    sup, cov = s2(b2(starts, ends), *st2.packed)
    assert sup.dtype == torch.int32 and cov.dtype == torch.int64
    np.testing.assert_array_equal(sup.numpy(), np.asarray(sup_j))
    np.testing.assert_array_equal(cov.numpy(), combine_coverage(res, est))
    assert sup.sum() > 0 and n < N
    b3, s3 = ts.make_batch_scorer(ic, is_, ie, engine="cuda", device="cpu")
    assert torch.equal(sup, s3(b3(starts, ends), *packed3)[0])
    with pytest.raises(ValueError, match="NM gate"):
        ts.make_batch_scorer(ic, is_, ie, engine="cuda2", device="cpu",
                             max_nm=0.1)
    far = np.arange(8191)
    with pytest.raises(ValueError, match="cuda6"):
        ts.make_batch_scorer(np.zeros(8191, np.int32), far, far + 1,
                             engine="cuda2", device="cpu")


def test_cpu_wrappers_do_not_launch():
    before = dict(kernels.LAUNCHES)
    cols = _cpu(_case("dense")[0])
    kernels.pair2_hitmask(*cols, CUTOFF, MIN_MAPQ, GAP)
    kernels.pair2_support(*cols, N_INT, CUTOFF, MIN_MAPQ, GAP)
    assert kernels.LAUNCHES == before
    assert {"pair2", "pair2_support", "bin_overlap", "match_matrix"} \
        <= set(before)


@pytest.mark.parametrize("bad", ["dtype", "length", "strided", "n_int"])
def test_wrapper_checks(bad):
    q, a, b, m = _cpu(_case("dense")[0])
    n_int = N_INT
    if bad == "dtype":
        q = q.to(torch.int64)
    elif bad == "length":
        a = a[:-1]
    elif bad == "strided":
        q, a, b, m = q[::2], a[::2], b[::2], m[::2]
    else:
        n_int = 8191
    with pytest.raises(ValueError):
        kernels.pair2_support(q, a, b, m, n_int, CUTOFF, MIN_MAPQ, GAP)
    if bad != "n_int":
        with pytest.raises(ValueError):
            kernels.pair2_hitmask(q, a, b, m, CUTOFF, MIN_MAPQ, GAP)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "edge", "pad", "mapq", "wrap"])
def test_cuda_kernels_equal_plain(cuda_device, kind):
    packed, _ = _case(kind, n=N * 64 + 3)   # a tail past the 4-wide loop
    cols = [torch.from_numpy(c).to(cuda_device) for c in packed]
    launches = dict(kernels.LAUNCHES)
    hit, iog = kernels.pair2_hitmask(*cols, CUTOFF, MIN_MAPQ, GAP)
    sup = kernels.pair2_support(*cols, N_INT, CUTOFF, MIN_MAPQ, GAP)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pair2"] == launches["pair2"] + 1
    assert kernels.LAUNCHES["pair2_support"] == \
        launches["pair2_support"] + 1
    hit_p, iog_p = kernels.pair2_hitmask_torch(*cols, CUTOFF, MIN_MAPQ, GAP)
    assert torch.equal(hit, hit_p) and torch.equal(iog, iog_p)
    assert torch.equal(sup, kernels.pair2_support_torch(
        *cols, N_INT, CUTOFF, MIN_MAPQ, GAP))
    # fewer bins than gate indices: the rest is dropped
    assert torch.equal(
        kernels.pair2_support(*cols, 5, CUTOFF, MIN_MAPQ, GAP),
        kernels.pair2_support_torch(*cols, 5, CUTOFF, MIN_MAPQ, GAP))
    # an unaligned view takes the scalar loop
    off = [c[1:] for c in cols]
    hit_o, iog_o = kernels.pair2_hitmask(*off, CUTOFF, MIN_MAPQ, GAP)
    assert torch.equal(hit_o, hit_p[1:]) and torch.equal(iog_o, iog_p[1:])
    assert torch.equal(
        kernels.pair2_support(*off, N_INT, CUTOFF, MIN_MAPQ, GAP),
        kernels.pair2_support_torch(*off, N_INT, CUTOFF, MIN_MAPQ, GAP))
