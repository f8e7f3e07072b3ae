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
    from coral_tpu_torch.ops import coverage
    assert not hasattr(coverage, "bin_coverage_sharded")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("origin,bin_size,n_bins", BINNINGS + [
    (0, 1, 100_000),          # past the shared-memory bins, a bin a base
    (0, 300, 5_000),          # past the shared-memory bins
    (-2**31, 2**20, 4096)])   # all of int32, a 64-bit division
def test_cuda_bin_overlap_equals_plain(cuda_device, origin, bin_size, n_bins):
    starts, ends = _reads(n=200_003, seed=7)
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
