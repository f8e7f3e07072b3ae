"""The port's coverage module (``coral_tpu_torch.ops.coverage``) and K8
(``kernels.bin_overlap``) against the JAX package's ``CoverageIndex`` and
``bin_coverage_pallas`` (interpret mode).

On the CPU the wrapper runs its plain PyTorch version.  Everything is an
integer sum: the tolerance is zero, compared as int64.  The CUDA kernel
itself is held against the plain version by the tests marked ``cuda``
(skipped without a card) and by ``chip_smoke.py``.  This module imports
JAX only inside the tests that need it, so that on a machine with a card
and no JAX
``python -m pytest --noconftest tests/test_torch_coverage.py -m cuda``
runs the card tests.
"""
import numpy as np
import pytest
import torch

from coral_tpu_torch.ops import kernels
from coral_tpu_torch.ops.coverage import CoverageIndex, bin_coverage


def _reads(n=3000, seed=1, span=900_000):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, span, n).astype(np.int64)
    ends = starts + rng.integers(100, 40_000, n)
    return starts, ends


def _bins_numpy(starts, ends, origin, bin_size, n_bins):
    """One bin at a time, in int64."""
    edges = origin + bin_size * np.arange(n_bins + 1, dtype=np.int64)
    s, e = np.asarray(starts, np.int64), np.asarray(ends, np.int64)
    return np.array([np.clip(np.minimum(e, hi) - np.maximum(s, lo), 0,
                             None).sum()
                     for lo, hi in zip(edges[:-1], edges[1:])], np.int64)


# (origin, bin_size, n_bins): the JAX test's shape; an origin inside the
# reads and a last edge before their end (clipping on both sides); a
# negative origin; bins much shorter than a read; one bin
BINNINGS = [(0, 50_000, 20), (123_456, 7_001, 32), (-250_000, 100_000, 13),
            (400_000, 97, 90), (10_000, 2_000_000, 1)]


@pytest.mark.parametrize("origin,bin_size,n_bins", BINNINGS)
def test_bin_overlap_plain_equals_pallas(origin, bin_size, n_bins):
    from coral_tpu.ops.pallas_kernels import bin_coverage_pallas

    starts, ends = _reads()
    # pads and empty reads add nothing
    starts[:40], ends[:40] = 0, 0
    ends[40:60] = starts[40:60]
    want = bin_coverage_pallas(starts, ends, origin, bin_size, n_bins,
                               interpret=True)
    got = kernels.bin_overlap(torch.from_numpy(starts.astype(np.int32)),
                              torch.from_numpy(ends.astype(np.int32)),
                              origin, bin_size, n_bins)
    assert got.dtype == torch.int64 and got.shape == (n_bins,)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(
        got.numpy(), _bins_numpy(starts, ends, origin, bin_size, n_bins))
    np.testing.assert_array_equal(
        bin_coverage(starts, ends, origin, bin_size, n_bins, device="cpu"),
        got.numpy())
    assert got.sum() > 0


def _spans_case(kind):
    """Reads for the decomposition of K8's plain version: (starts, ends,
    origin, bin_size, n_bins)."""
    rng = np.random.default_rng(11)
    if kind == "three_or_more_bins":
        s = rng.integers(0, 120_000, 2000)
        return s, s + rng.integers(2_000, 40_000, 2000), 5_000, 1_000, 120
    if kind == "on_edges":
        # starts and ends exactly on edges, one base either side of them,
        # and reads of whole bins only
        k = rng.integers(0, 60, 2000)
        s = 1_000 + 500 * k + rng.choice([-1, 0, 0, 1], 2000)
        e = 1_000 + 500 * (k + rng.integers(0, 6, 2000)) \
            + rng.choice([-1, 0, 0, 1], 2000)
        return s, e, 1_000, 500, 64
    if kind == "one_base_bins":
        s = rng.integers(-20, 160, 2000)
        return s, s + rng.integers(0, 40, 2000), 0, 1, 150
    if kind == "clipped_both_ends":
        # reads that start before the first edge, end past the last, or
        # both (every bin whole), among empty and reversed reads
        s = rng.integers(-50_000, 150_000, 2000)
        e = s + rng.integers(-500, 200_000, 2000)
        return s, e, 20_000, 3_000, 30
    if kind == "few_reads_many_bins":
        # a handful of reads each spanning a hundred bins or more: long
        # runs of the difference array, partials at both ends
        s = rng.integers(0, 1_000, 7)
        return s, s + rng.integers(5_000, 9_000, 7), 0, 43, 200
    s = np.sort(rng.integers(0, 400_000, 3000))     # sorted by start
    return s, s + rng.integers(100, 25_000, 3000), 0, 7_000, 60


@pytest.mark.parametrize("kind", ["three_or_more_bins", "on_edges",
                                  "one_base_bins", "sorted",
                                  "clipped_both_ends", "few_reads_many_bins"])
def test_bin_overlap_plain_decomposition(kind):
    """The plain version's partials + difference array of counts + cumsum
    against the Pallas kernel (interpret mode) and a bin-at-a-time numpy
    sum, where a read spans three or more bins, starts or ends on an edge,
    where bins are one base, over reads sorted by start, where reads
    reach past both ends of the binned range, and where a few reads span
    a hundred bins or more each."""
    from coral_tpu.ops.pallas_kernels import bin_coverage_pallas

    starts, ends, origin, bin_size, n_bins = _spans_case(kind)
    starts, ends = starts.astype(np.int32), ends.astype(np.int32)
    lo = np.maximum(starts.astype(np.int64), origin)
    hi = np.minimum(ends.astype(np.int64), origin + bin_size * n_bins)
    live = hi > lo
    first = (lo[live] - origin) // bin_size
    last = (hi[live] - 1 - origin) // bin_size
    if kind == "three_or_more_bins":
        assert (last - first >= 2).mean() > 0.5
    if kind == "on_edges":
        assert ((starts - origin) % bin_size == 0).sum() > 500
        assert ((ends - origin) % bin_size == 0).sum() > 500
    got = kernels.bin_overlap(torch.from_numpy(starts),
                              torch.from_numpy(ends), origin, bin_size,
                              n_bins)
    want = bin_coverage_pallas(starts, ends, origin, bin_size, n_bins,
                               interpret=True)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(
        got.numpy(), _bins_numpy(starts, ends, origin, bin_size, n_bins))
    assert got.sum() > 0


@pytest.mark.parametrize("origin,bin_size,n_bins", BINNINGS)
def test_coverage_index_equals_jax(origin, bin_size, n_bins):
    from coral_tpu.ops.coverage import CoverageIndex as JaxIndex

    starts, ends = _reads(seed=2)
    want, got = JaxIndex(starts, ends), CoverageIndex(starts, ends,
                                                      device="cpu")
    assert got.n == want.n == len(starts)
    rng = np.random.default_rng(3)
    xs = rng.integers(-10_000, 1_000_000, 500)
    np.testing.assert_array_equal(got.prefix(xs), want.prefix(xs))
    qs = rng.integers(0, 900_000, 200)
    qe = qs + rng.integers(1, 300_000, 200)
    cov = got.interval_coverage(qs, qe)
    assert cov.dtype == np.int64
    np.testing.assert_array_equal(cov, want.interval_coverage(qs, qe))
    hist = got.bin_histogram(origin, bin_size, n_bins)
    assert hist.dtype == np.int64
    np.testing.assert_array_equal(
        hist, want.bin_histogram(origin, bin_size, n_bins))
    # the prefix-sum histogram and the scatter histogram are one function
    np.testing.assert_array_equal(
        hist, bin_coverage(starts, ends, origin, bin_size, n_bins,
                           device="cpu"))


def test_bin_overlap_int64_where_the_tpu_kernel_wraps():
    """A bin's total past 2^31 and an edge past int32: the port sums and
    places edges in int64 (the Pallas kernel would wrap on both), and
    equals the prefix-sum histogram."""
    rng = np.random.default_rng(5)
    n = 200_000
    starts = rng.integers(0, 1_000_000, n).astype(np.int32)
    ends = (starts + rng.integers(20_000, 40_000, n)).astype(np.int32)
    got = bin_coverage(starts, ends, 0, 2_000_000, 2, device="cpu")
    assert got[0] > np.iinfo(np.int32).max
    assert got[0] == (ends.astype(np.int64) - starts).sum() and got[1] == 0
    far = np.array([2**31 - 1000], np.int32), np.array([2**31 - 1], np.int32)
    hist = bin_coverage(*far, 2**31 - 1500, 1000, 4, device="cpu")
    np.testing.assert_array_equal(hist, [500, 499, 0, 0])
    np.testing.assert_array_equal(
        hist, CoverageIndex(*far, device="cpu").bin_histogram(
            2**31 - 1500, 1000, 4))


def test_bin_overlap_edge_cases():
    """bin_size = 1; a read that covers every bin; reads wholly outside the
    range; reads that end or start exactly on an edge; no reads at all."""
    s = np.array([5, 0, -100, 90, 2_000, -50, 30, 20], np.int32)
    e = np.array([9, 1_000, -10, 130, 3_000, 10, 30, 40], np.int32)
    for origin, bin_size, n_bins in [(0, 1, 100), (10, 10, 9), (0, 7, 15)]:
        got = bin_coverage(s, e, origin, bin_size, n_bins, device="cpu")
        np.testing.assert_array_equal(
            got, _bins_numpy(s, e, origin, bin_size, n_bins))
    one = bin_coverage(s, e, 0, 1, 100, device="cpu")
    # [0, 1000) and [-50, 10); those and [5, 9); [0, 1000) and [90, 130)
    assert one[4] == 2 and one[5] == 3 and one[99] == 2
    none = bin_coverage(s[:0], e[:0], 0, 10, 4, device="cpu")
    assert none.dtype == np.int64 and not none.any()


def test_coverage_checks():
    s, e = _reads(n=10)
    with pytest.raises(ValueError, match="int32"):
        CoverageIndex(s, e + 2**31, device="cpu")
    with pytest.raises(ValueError, match="int32"):
        bin_coverage(s - 2**32, e, 0, 10, 4, device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        bin_coverage(s, e, 0, 10, 4, engine="pallas", device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        bin_coverage(s, e, 0, 10, 4, engine="cuda", device="cpu")
    for bad in [(0, 0, 4), (0, 10, 0), (0, 2**40, 2**30)]:
        with pytest.raises(ValueError):
            bin_coverage(s, e, *bad, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            bin_coverage(s, e, 0, 10, 4, engine="cuda", device="cuda")
        with pytest.raises(RuntimeError):
            CoverageIndex(s, e, device="cuda")
    from coral_tpu_torch.ops.coverage import bin_coverage_sharded
    from coral_tpu_torch.parallel import make_mesh
    mesh = make_mesh(devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="int32"):
        bin_coverage_sharded(s, e + 2**31, 0, 10, 4, mesh)
    with pytest.raises(ValueError, match="CUDA device"):
        bin_coverage_sharded(s, e, 0, 10, 4, mesh, engine="cuda")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["random", "sorted"])
@pytest.mark.parametrize("origin,bin_size,n_bins", BINNINGS + [
    (0, 1, 100_000),          # past one shared-memory tile, a bin a base
    (0, 300, 5_000),
    (-2**31, 2**20, 4096)])   # all of int32, a 64-bit division
def test_cuda_bin_overlap_equals_plain(cuda_device, origin, bin_size, n_bins,
                                       order):
    starts, ends = _reads(n=200_003, seed=7)
    if order == "sorted":
        idx = np.argsort(starts, kind="stable")
        starts, ends = starts[idx], ends[idx]
    starts[:5], ends[:5] = [-2**31, -5, 0, 2**31 - 10, 100], \
        [2**31 - 1, 2**31 - 1, 1_000_000, 2**31 - 1, 50]
    s = torch.from_numpy(starts.astype(np.int32)).to(cuda_device)
    e = torch.from_numpy(ends.astype(np.int32)).to(cuda_device)
    before = kernels.LAUNCHES["bin_overlap"]
    got = kernels.bin_overlap(s, e, origin, bin_size, n_bins)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bin_overlap"] == before + 1
    assert torch.equal(got, kernels.bin_overlap_torch(s, e, origin, bin_size,
                                                      n_bins))
    # the kernel counts a read with e < s as empty; the prefix sums would
    # count it negative
    live = ends >= starts
    assert not live.all()
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        CoverageIndex(starts[live], ends[live], device=cuda_device)
        .bin_histogram(origin, bin_size, n_bins))
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        bin_coverage(starts, ends, origin, bin_size, n_bins, engine="cuda",
                     device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["random", "sorted"])
def test_cuda_bin_overlap_route_switches(cuda_device, order):
    """K8 at n_bins at and either side of the switch of its plan on this
    card (the bins leave one shared-memory tile), and at one bin and 2^20
    bins (37 tiles), over random reads and reads sorted by start (where a
    warp's lanes share a bin and a block reaches few bins)."""
    from chip_smoke import bin_switches

    starts, ends = _reads(n=200_003, seed=9, span=3_000_000)
    if order == "sorted":
        idx = np.argsort(starts, kind="stable")
        starts, ends = starts[idx], ends[idx]
    s = torch.from_numpy(starts.astype(np.int32)).to(cuda_device)
    e = torch.from_numpy(ends.astype(np.int32)).to(cuda_device)
    switches = bin_switches(kernels, len(starts))
    plans = [kernels.bin_overlap_plan(len(starts), n, cuda_device)
             for n in switches]
    assert [p["tiles"] for p in plans] == [1, 2, 2]
    for n_bins in (1, *switches, 1 << 20):
        bin_size = max(1, 3_100_000 // n_bins)
        plan = kernels.bin_overlap_plan(len(starts), n_bins, cuda_device)
        before = kernels.LAUNCHES["bin_overlap"]
        got = kernels.bin_overlap(s, e, 0, bin_size, n_bins)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["bin_overlap"] == before + 1
        want = kernels.bin_overlap_torch(s, e, 0, bin_size, n_bins)
        assert torch.equal(got, want), (n_bins, plan)


def test_bin_coverage_reversed_reads_count_nothing():
    """A read with end < start adds nothing to bin_coverage (as K8 and the
    TPU kernel, max(overlap, 0)), where the prefix sums of CoverageIndex,
    in both packages, count it negative: the qualifier the docstring
    states."""
    from coral_tpu.ops.coverage import CoverageIndex as JaxCoverageIndex

    starts = np.array([100, 500, 250], np.int32)
    ends = np.array([300, 400, 260], np.int32)       # the second reversed
    got = bin_coverage(starts, ends, 0, 200, 3, device="cpu")
    np.testing.assert_array_equal(got, [100, 110, 0])
    forward = bin_coverage(starts[[0, 2]], ends[[0, 2]], 0, 200, 3,
                           device="cpu")
    np.testing.assert_array_equal(got, forward)
    want = CoverageIndex(starts, ends, device="cpu").bin_histogram(0, 200, 3)
    np.testing.assert_array_equal(want, [100, 110, -100])
    np.testing.assert_array_equal(
        JaxCoverageIndex(starts, ends).bin_histogram(0, 200, 3), want)
