"""The interval index of the port (``coral_tpu_torch.ops.interval_index``)
against the first-overlap function it replaces.

``build_interval_index`` + ``first_overlap_indexed_torch`` are held here
against ``coral_tpu.ops.scoring.first_overlap`` (numpy) on adversarial
tables, and the 6-column predicate decided on the index against
``pair_predicates_pallas_packed`` in interpret mode.  Interval indices and
masks are integers: the tolerance is zero.  The CUDA build and K3, K4 on
the index are held against these plain versions by the tests marked
``cuda`` in ``tests/test_torch_kernels6.py`` and by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from chip_smoke import (N_DECOYS, _interval_arrays, decoy_intervals,
                        dense_case6)
from coral_tpu_torch.ops import kernels
from coral_tpu_torch.ops.interval_index import (NONE, build_interval_index,
                                                build_interval_index_torch,
                                                first_overlap_indexed_torch,
                                                top_level)
from coral_tpu_torch.ops.layout import LANES
from coral_tpu_torch.ops.scoring import pair_predicate, unpack_pair_meta

CUTOFF = 100
MIN_MAPQ = 20
GAP = 100.0
ROWS = 8                  # 8 x 128 pairs: interpret-mode Pallas stays fast
N = ROWS * LANES
I32 = np.iinfo(np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _table(kind: str, n: int, rng):
    """An int32 interval table of ``n`` rows of one adversarial kind."""
    ic = rng.integers(0, 4, n)
    is_ = rng.integers(0, 100_000, n)
    ie = is_ + rng.integers(1, 30_000, n)
    if kind == "overlapping":        # nested and overlapping, any order
        is_ = rng.integers(0, 20_000, n)
        ie = is_ + rng.integers(1, 80_000, n)
    elif kind == "duplicate":        # every row repeated, out of order
        k = max(n // 3, 1)
        pick = rng.integers(0, k, n)
        ic, is_, ie = ic[pick], is_[pick], ie[pick]
    elif kind == "empty":            # start > end on a third of the rows
        flip = rng.random(n) < 1 / 3
        is_, ie = np.where(flip, ie, is_), np.where(flip, is_, ie)
    elif kind == "chroms":           # pad rows, codes outside -1..30
        ic = rng.choice([-2, -1, 0, 1, 30, 31, 40, -5, I32.min, I32.max], n)
    elif kind == "extremes":         # bounds at the ends of int32
        ext = np.array([I32.min, I32.min + 1, -1, 0, 1, I32.max - 1,
                        I32.max])
        is_ = rng.choice(ext, n)
        ie = rng.choice(ext, n)
        ic = rng.integers(-1, 2, n)
    elif kind == "sorted":           # sorted by start, as a BED file is
        order = np.lexsort((is_, ic))
        ic, is_, ie = ic[order], is_[order], ie[order]
    return tuple(a.astype(np.int32) for a in (ic, is_, ie))


def _queries(kind: str, q: int, table, rng):
    """Sides (chrom, a, b) in storage order: '+' with a <= b, '-' with
    a > b (containment of [b, a]), about a third of them."""
    ic = table[0]
    lo = rng.integers(-10_000, 140_000, q)
    hi = lo + rng.integers(0, 40_000, q)
    minus = rng.random(q) < 1 / 3
    a, b = np.where(minus, hi, lo), np.where(minus, lo, hi)
    c = rng.integers(-1, 5, q)
    if kind == "chroms":
        c = rng.choice([-2, -1, 0, 30, 31, 40, I32.min, I32.max], q)
    elif kind == "extremes":
        ext = np.array([I32.min, I32.min + 1, -1, 0, 1, I32.max - 1,
                        I32.max])
        a, b = rng.choice(ext, q), rng.choice(ext, q)
        c = rng.integers(-1, 2, q)
    elif len(ic):                    # mostly on the table's chromosomes
        c = np.where(rng.random(q) < 0.8, rng.choice(ic, q), c)
    return tuple(x.astype(np.int32) for x in (c, a, b))


def _want(queries, table):
    from coral_tpu.ops.scoring import first_overlap

    q = len(queries[0])
    if len(table[0]) == 0:
        return np.full(q, -1)
    return first_overlap(np, *queries, *table)


KINDS = ["plain", "overlapping", "duplicate", "empty", "chroms", "extremes",
         "sorted"]


@pytest.mark.parametrize("n", [0, 1, 16, 8200])
@pytest.mark.parametrize("kind", KINDS)
def test_indexed_lookup_equals_first_overlap(kind, n):
    rng = np.random.default_rng(KINDS.index(kind) * 10_007 + n)
    table = _table(kind, n, rng)
    queries = _queries(kind, 512 if n == 8200 else 4096, table, rng)
    index = build_interval_index(*table, device="cpu")
    got = first_overlap_indexed_torch(index, *_t(*queries))
    assert got.dtype == torch.int64
    want = _want(queries, table)
    np.testing.assert_array_equal(got.numpy(), want)
    if n >= 16 and kind != "extremes":
        assert (want >= 0).any() and (want == -1).any()


@pytest.mark.parametrize("n", [2, 3, 5, 17, 1023, 1025, 4097])
def test_indexed_lookup_at_ragged_sizes(n):
    """Tables whose last block is not full at some level."""
    rng = np.random.default_rng(n)
    table = _table("overlapping", n, rng)
    queries = _queries("overlapping", 2048, table, rng)
    got = first_overlap_indexed_torch(build_interval_index(*table, "cpu"),
                                      *_t(*queries))
    np.testing.assert_array_equal(got.numpy(), _want(queries, table))


def _wgs_table(decoys_first: bool):
    """chip_smoke's long list: 10 real intervals and 8,190 decoys that no
    read overlaps, the decoys after or before the real ones."""
    real = [[f"chr{k}", 55_000_000, 55_400_000, 0] for k in range(1, 10)] \
        + [["chrX", 55_000_000, 55_400_000, 0]]
    decoys = decoy_intervals(N_DECOYS)
    ic, is_, ie = _interval_arrays(decoys + real if decoys_first
                                   else real + decoys)
    return ic, is_.astype(np.int32), ie.astype(np.int32)


@pytest.mark.parametrize("decoys_first", [False, True])
def test_indexed_lookup_with_decoys(decoys_first):
    """The decoys shift the real intervals' indices when they come first;
    the lookup follows."""
    table = _wgs_table(decoys_first)
    rng = np.random.default_rng(3)
    q = 2048
    c = rng.integers(-1, 12, q).astype(np.int32)
    lo = rng.integers(54_900_000, 55_500_000, q)
    hi = lo + rng.integers(0, 5_000, q)
    queries = (c, lo.astype(np.int32), hi.astype(np.int32))
    got = first_overlap_indexed_torch(build_interval_index(*table, "cpu"),
                                      *_t(*queries)).numpy()
    want = _want(queries, table)
    np.testing.assert_array_equal(got, want)
    real = want[want >= 0]
    assert len(real) > 100
    assert (real >= N_DECOYS).all() if decoys_first else (real < 10).all()


def _indexed_predicate(ints, packed):
    """The 6-column predicate with both sides looked up on the index."""
    index = build_interval_index(*ints, device="cpu")
    cols = _t(*packed)
    ci, si, mi, cj, sj, mj = unpack_pair_meta(cols[5])
    zero_i = torch.zeros_like(cols[0])
    zero_f = torch.zeros(cols[0].shape, dtype=torch.float32)
    return pair_predicate(
        zero_i, cols[0], ci, cols[1], cols[2], si, mi, zero_f,
        cj, cols[3], cols[4], sj, mj, zero_f, *_t(*ints),
        CUTOFF, MIN_MAPQ, GAP, float("inf"),
        first_overlap_fn=lambda c, a, b, *_: first_overlap_indexed_torch(
            index, c, a, b))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n_int", [1, 16, 300])
def test_indexed_predicate_equals_pallas(n_int, seed):
    from coral_tpu.ops.pallas_kernels import pair_predicates_pallas_packed

    ints, packed = dense_case6(N, n_int, seed)
    want_hit, want_io = pair_predicates_pallas_packed(
        packed, N, *ints, CUTOFF, MIN_MAPQ, GAP, interpret=True)
    hit, io = _indexed_predicate(ints, packed)
    np.testing.assert_array_equal(hit.numpy(), want_hit)
    np.testing.assert_array_equal(io.numpy(), want_io)
    assert want_hit.any() and not want_hit.all() and (want_io >= 0).any()


@pytest.mark.parametrize("hot", [False, True])
def test_indexed_predicate_at_8200_intervals(hot):
    """Past the resolved layouts' limit, against the scan's plain version
    (the Pallas kernel unrolls a step per interval: too slow to trace at
    this width in interpret mode)."""
    from coral_tpu.ops.scoring import first_overlap

    ints, packed = dense_case6(N, 8200, seed=19 if hot else 13,
                               hot=[3, 100, 2047, 1000] if hot else None)
    hit, io = _indexed_predicate(ints, packed)
    want_hit, want_io = kernels.pair6_hitmask_torch(
        *_t(*ints), *_t(*packed), cutoff=CUTOFF, min_mapq=MIN_MAPQ,
        gap_=GAP)
    assert torch.equal(hit, want_hit) and torch.equal(io.int(), want_io)
    ci = ((packed[5] >> 14) >> 9) - 1
    np.testing.assert_array_equal(
        io.numpy(), first_overlap(np, ci, packed[1], packed[2], *ints))
    assert (io.numpy() > 4000).any() or hot


def _levels_by_definition(ic, is_, ie):
    """``lev`` from its definition (module docstring), block by block."""
    n = len(ic)
    top = top_level(n)
    s = ic.astype(np.int64) * 2**32 + is_ + 2**31
    e = ic.astype(np.int64) * 2**32 + ie + 2**31
    order = np.argsort(s, kind="stable")
    lev = np.zeros((top + 1, n, 8), np.int64)
    lev[0, :, 4:7] = NONE
    for level in range(top + 1):
        for b0 in range(0, n, 4 ** level):
            pos = np.arange(b0, min(b0 + 4 ** level, n))
            # E descending, ties by position
            slots = pos[np.lexsort((pos, -e[order[pos]]))]
            rows = slice(b0, b0 + len(pos))
            lev[level, rows, 0] = np.minimum.accumulate(order[slots])
            if not level:
                continue
            child = (slots - b0) // 4 ** (level - 1)
            for d in range(3):
                lev[level, rows, 1 + d] = np.cumsum(child <= d)
                lev[level, rows, 4 + d] = np.minimum.accumulate(
                    np.where(child <= d, order[slots], NONE))
    return top, np.sort(s), np.sort(e)[::-1], lev


@pytest.mark.parametrize("kind", ["plain", "duplicate", "chroms"])
@pytest.mark.parametrize("n", [1, 7, 64, 100, 1100])
def test_levels_follow_their_definition(kind, n):
    """The tensors of the plain build, which the card's build must equal
    bit for bit."""
    table = _table(kind, n, np.random.default_rng(n))
    index = build_interval_index_torch(*_t(*table))
    top, skey, ekey, lev = _levels_by_definition(*table)
    assert index.n == n and index.top == top
    assert index.lev.dtype == torch.int32 and index.lev.shape == lev.shape
    np.testing.assert_array_equal(index.skey.numpy(), skey)
    np.testing.assert_array_equal(index.ekey.numpy(), ekey)
    np.testing.assert_array_equal(index.lev.numpy(), lev)


@pytest.mark.parametrize("n,top", [(0, 0), (1, 0), (2, 1), (4, 1), (5, 2),
                                   (16, 2), (17, 3), (4096, 6), (8200, 7)])
def test_top_level(n, top):
    assert top_level(n) == top


def test_build_checks_its_table():
    ic, is_, ie = _t(*_table("plain", 16, np.random.default_rng(0)))
    with pytest.raises(ValueError):
        build_interval_index_torch(ic, is_, ie[:-1])
    with pytest.raises(ValueError):
        build_interval_index_torch(ic, is_.to(torch.int64), ie)
    with pytest.raises(ValueError):
        build_interval_index(ic, is_, ie, device="meta")


def test_cpu_wrappers_take_an_index_and_do_not_launch():
    """On the CPU K3 and K4 run their plain versions, with or without an
    index, and nothing is counted."""
    ints, packed = dense_case6(N, 300, seed=2)
    args = (*_t(*ints), *_t(*packed))
    kw = dict(cutoff=CUTOFF, min_mapq=MIN_MAPQ, gap_=GAP)
    before = dict(kernels.LAUNCHES)
    index = build_interval_index(*ints, device="cpu")
    hit, io = kernels.pair6_hitmask(*args, **kw, index=index)
    sup = kernels.pair6_support(*args, **kw, index=index)
    want_hit, want_io = kernels.pair6_hitmask_torch(*args, **kw)
    assert torch.equal(hit, want_hit) and torch.equal(io, want_io)
    assert torch.equal(sup, kernels.pair6_support_torch(*args, **kw))
    assert kernels.LAUNCHES == before
