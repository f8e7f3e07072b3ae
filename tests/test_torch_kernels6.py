"""K3, K4 and K7 of the port (``coral_tpu_torch.ops.kernels``) against the
Pallas kernels they replace.

On the CPU the wrappers run their plain PyTorch versions, which are held
here against ``pair_predicates_pallas_packed``, ``make_pair_hist_pallas_fn``
and ``make_stream_control_fn`` in interpret mode, bit for bit: masks,
interval indices and counts are integers, so the tolerance is zero.  The
CUDA kernels themselves are held against the plain versions by the tests
marked ``cuda`` (skipped without a card) and by ``chip_smoke.py``.  This
module imports JAX only inside the tests that need it, so that on a
machine with a card and no JAX
``python -m pytest --noconftest tests/test_torch_kernels6.py -m cuda``
runs the card tests.
"""
import numpy as np
import pytest
import torch

from chip_smoke import HOT_WINDOWS, dense_case, dense_case6
from coral_tpu_torch.ops import kernels
from coral_tpu_torch.ops.layout import LANES
from coral_tpu_torch.ops.scoring import (pair_predicate_packed_np,
                                         state_from_numpy,
                                         unpack_pair_meta_np)

CUTOFF = 100
MIN_MAPQ = 20
GAP = 100.0
ROWS = 8                  # 8 x 128 pairs: interpret-mode Pallas stays fast
N = ROWS * LANES
KW = dict(cutoff=CUTOFF, min_mapq=MIN_MAPQ, gap_=GAP)


def _cpu(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_case6_has_every_row_kind():
    """The shared 6-column case holds what the kernels must get right:
    hits and misses, threshold edges on both sides of the line, query-gap
    edges, pad rows, ends of int32, '-' strand sides stored r1 > r2, MAPQ
    on both sides of the gate, and sides whose first interval is not the
    only one that covers them."""
    (ic, is_, ie), packed = dense_case6(N, 300, seed=0)
    qgap, r1_i, r2_i, r1_j, r2_j, meta = (c.astype(np.int64) for c in packed)
    ci, si, mi, cj, sj, mj = unpack_pair_meta_np(packed[5])
    hit, io = pair_predicate_packed_np(*packed, ic, is_, ie, CUTOFF,
                                       MIN_MAPQ, GAP)
    assert 0.1 < hit.mean() < 0.6
    pad = (meta == 0) & (qgap == 0)
    assert pad.any() and not hit[pad].any()
    wrap = ci == 30
    assert wrap.sum() >= 4 and (io[wrap] == 299).all()
    assert ((si < 0) & (r1_i > r2_i)).any()
    assert ((sj < 0) & (r1_j > r2_j)).any()
    assert (mi < MIN_MAPQ).any() and (mi == MIN_MAPQ).any()
    same = (si > 0) & (sj > 0) & ~wrap
    off = np.abs(qgap - (r1_j - r2_i)) - np.abs(qgap) // 5
    edge = same & (np.abs(qgap) % 5 == 0) & (np.abs(off) <= 1) \
        & (np.abs(qgap) > 500)
    assert edge.sum() > 20 and hit[edge].any() and not hit[edge].all()
    assert (qgap == -CUTOFF).any() and (qgap == -CUTOFF - 1).any()
    covered_twice = (io == 0) & (r1_i >= 400_000) & (ci == 0)
    assert covered_twice.any()
    assert (io == -1).any() and ((io >= 0) & ~hit).any()


def test_case6_hot_bins_collide():
    """The hot-bin case of K4 above 8190 intervals: the hits fall on at
    most 16 intervals, several of which share a slot of the kernel's
    2048-slot cache, and the plain version counts them as numpy does."""
    ints, packed = dense_case6(N, 8200, seed=19, hot=HOT_WINDOWS)
    hit, io = pair_predicate_packed_np(*packed, *ints, CUTOFF, MIN_MAPQ,
                                       GAP)
    bins = np.unique(io[hit])
    assert 10 <= len(bins) <= 16
    slots, per_slot = np.unique(bins % 2048, return_counts=True)
    assert (per_slot >= 3).sum() >= 3
    sup = kernels.pair6_support(*_cpu(ints), *_cpu(packed), **KW)
    np.testing.assert_array_equal(
        sup.numpy(), np.bincount(io[hit], minlength=8200))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n_int", [1, 16, 300])
def test_pair6_hitmask_plain_equals_pallas(n_int, seed):
    from coral_tpu.ops.pallas_kernels import pair_predicates_pallas_packed

    ints, packed = dense_case6(N, n_int, seed)
    want_hit, want_io = pair_predicates_pallas_packed(
        packed, N, *ints, CUTOFF, MIN_MAPQ, GAP, interpret=True)
    hit, io = kernels.pair6_hitmask(*_cpu(ints), *_cpu(packed), **KW)
    assert hit.dtype == torch.bool and io.dtype == torch.int32
    np.testing.assert_array_equal(hit.numpy(), want_hit)
    np.testing.assert_array_equal(io.numpy(), want_io)
    assert want_hit.any() and not want_hit.all()
    assert (want_io >= 0).any()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n_int", [1, 16, 300])
def test_pair6_support_plain_equals_pallas(n_int, seed):
    from coral_tpu.ops.pallas_kernels import (make_pair_hist_pallas_fn,
                                              pair_predicates_pallas_packed)

    ints, packed = dense_case6(N, n_int, seed)
    if n_int <= 16:
        fn = make_pair_hist_pallas_fn(ROWS, n_int, CUTOFF, MIN_MAPQ, GAP,
                                      interpret=True)
        want = np.asarray(fn(*[a.reshape(1, n_int) for a in ints],
                             *[c.reshape(ROWS, LANES) for c in packed]))[0]
    else:
        # the fused kernel unrolls a second loop over the bins and takes
        # minutes to trace at this width in interpret mode: its definition,
        # the counts of hit & (io_i == k), from the unfused Pallas kernel
        hit, io = pair_predicates_pallas_packed(
            packed, N, *ints, CUTOFF, MIN_MAPQ, GAP, interpret=True)
        want = np.bincount(io[hit], minlength=n_int)
    got = kernels.pair6_support(*_cpu(ints), *_cpu(packed), **KW)
    assert got.dtype == torch.int32 and got.shape == (n_int,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


def _wrap_case():
    ext = np.array([-2**31, -2**31 + 1, 2**31 - 1, 2**31 - 100, -1, 0],
                   np.int64)
    rng = np.random.default_rng(5)
    return [rng.choice(ext, N).astype(np.int32) for _ in range(3)]


@pytest.mark.parametrize("kind", ["dense", "wrap"])
def test_stream_control_plain_equals_pallas(kind):
    from coral_tpu.ops.pallas_kernels import make_stream_control_fn

    cols = dense_case(N, 16, seed=2) if kind == "dense" else _wrap_case()
    want = np.asarray(make_stream_control_fn(ROWS, interpret=True)(
        *[c.reshape(ROWS, LANES) for c in cols])).reshape(-1)
    got = kernels.stream_control(*_cpu(cols))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_pair6_more_intervals_than_the_v3_layout_holds():
    """8,200 intervals on a few rows, against the host numpy predicate
    (the Pallas kernel unrolls one scan step per interval, too slow to
    trace at this width in interpret mode)."""
    ints, packed = dense_case6(256, 8200, seed=4)
    hit, io = kernels.pair6_hitmask(*_cpu(ints), *_cpu(packed), **KW)
    sup = kernels.pair6_support(*_cpu(ints), *_cpu(packed), **KW)
    want_hit, want_io = pair_predicate_packed_np(*packed, *ints, CUTOFF,
                                                 MIN_MAPQ, GAP)
    rows = (packed[5] >> 23) != 31    # float64 threshold: not at int32 ends
    np.testing.assert_array_equal(hit.numpy()[rows], want_hit[rows])
    np.testing.assert_array_equal(io.numpy(), want_io)
    np.testing.assert_array_equal(
        sup.numpy(), np.bincount(io.numpy()[hit.numpy()], minlength=8200))
    assert (io.numpy() > 4000).any()


def test_first_overlap_chunks_do_not_change_the_answer(monkeypatch):
    from coral_tpu_torch.ops import scoring

    ints, packed = dense_case6(N, 300, seed=6)
    args = (*_cpu(ints), *_cpu(packed))
    want = kernels.pair6_hitmask(*args, **KW)
    monkeypatch.setattr(scoring, "_OVERLAP_CELLS", 300 * 37)
    got = kernels.pair6_hitmask(*args, **KW)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_cpu_wrappers_do_not_launch():
    before = dict(kernels.LAUNCHES)
    ints, packed = dense_case6(N, 16, seed=0)
    kernels.pair6_hitmask(*_cpu(ints), *_cpu(packed), **KW)
    kernels.pair6_support(*_cpu(ints), *_cpu(packed), **KW)
    kernels.stream_control(*_cpu(dense_case(N, 16, seed=0)))
    assert kernels.LAUNCHES == before
    assert set(before) == {"pair3", "pair3_support", "pair6",
                           "pair6_support", "stream_control", "pair2",
                           "pair2_support", "bin_overlap", "match_matrix"}


@pytest.mark.parametrize("bad", ["dtype", "length", "strided", "columns",
                                 "table"])
def test_wrapper_checks(bad):
    ints, packed = dense_case6(N, 16, seed=0)
    ints, packed = _cpu(ints), _cpu(packed)
    if bad == "dtype":
        packed[0] = packed[0].to(torch.int64)
    elif bad == "length":
        packed[1] = packed[1][:-1]
    elif bad == "strided":
        packed = [c[::2] for c in packed]
    elif bad == "columns":
        packed = packed[:5]
    else:
        ints[1] = ints[1].to(torch.int64)
    with pytest.raises((ValueError, TypeError)):
        kernels.pair6_hitmask(*ints, *packed, **KW)
    with pytest.raises((ValueError, TypeError)):
        kernels.pair6_support(*ints, *packed, **KW)
    if bad in ("dtype", "length", "strided"):
        with pytest.raises(ValueError):
            kernels.stream_control(*packed[:3])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_int,hot,n", [
    (1, False, N * 40 + 3), (16, False, N * 40 + 3), (511, False, N * 40 + 3),
    (512, False, N * 40 + 3), (513, False, N * 40 + 3),
    (8190, False, N * 40 + 3), (8200, False, N * 40 + 3),
    (8200, True, N * 40 + 3), (16, False, 1001), (8200, True, 1001)])
def test_cuda_pair6_kernels_equal_plain(cuda_device, n_int, hot, n):
    """K3 and K4 on the card: around the 512-interval tile, at K4's switch
    from shared-memory bins to its cache of bins (8190 / 8200), with every
    hit on a few intervals whose cache slots collide (``hot``), with a
    last block that is not full, and on a batch of 1,001 pairs (four
    blocks)."""
    ints, packed = dense_case6(n, n_int, seed=19 if hot else n_int,
                               hot=HOT_WINDOWS if hot else None)
    st = state_from_numpy(*ints, packed, device=cuda_device)
    args = (st.int_chrom, st.int_start, st.int_end, *st.packed)
    launches = dict(kernels.LAUNCHES)
    hit, io = kernels.pair6_hitmask(*args, **KW)
    sup = kernels.pair6_support(*args, **KW)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pair6"] == launches["pair6"] + 1
    assert kernels.LAUNCHES["pair6_support"] == launches["pair6_support"] + 1
    want_hit, want_io = kernels.pair6_hitmask_torch(*args, **KW)
    assert torch.equal(hit, want_hit) and torch.equal(io, want_io)
    assert torch.equal(sup, kernels.pair6_support_torch(*args, **KW))
    assert int(sup.sum()) == int(hit.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_int", [8193, 8200, 20_000])
def test_cuda_pair6_support_cache_collisions(cuda_device, n_int):
    """K4 above 8190 intervals with every hit on a few intervals whose
    cache slots collide (bin % 2048): the slot's first bin counts on the
    SM, the others fall through to global atomics, and the counts are
    exact."""
    ints, packed = dense_case6(N * 40 + 3, n_int, seed=19, hot=HOT_WINDOWS)
    st = state_from_numpy(*ints, packed, device=cuda_device)
    args = (st.int_chrom, st.int_start, st.int_end, *st.packed)
    sup = kernels.pair6_support(*args, **KW)
    hit, io = kernels.pair6_hitmask(*args, **KW)
    torch.cuda.synchronize()
    assert torch.equal(sup, kernels.pair6_support_torch(*args, **KW))
    assert int(sup.sum()) == int(hit.sum()) > 0
    assert int((sup > 0).sum()) <= 16


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "wrap"])
def test_cuda_stream_control_equals_plain(cuda_device, kind):
    cols = dense_case(N * 64 + 3, 16, seed=2) if kind == "dense" \
        else _wrap_case()
    cols = [torch.from_numpy(c).to(cuda_device) for c in cols]
    launches = kernels.LAUNCHES["stream_control"]
    got = kernels.stream_control(*cols)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["stream_control"] == launches + 1
    assert torch.equal(got, kernels.stream_control_torch(*cols))
    off = [c[1:] for c in cols]     # an unaligned view: the scalar loop
    assert torch.equal(kernels.stream_control(*off),
                       kernels.stream_control_torch(*off))
