"""K9 of the port (``kernels.match_matrix``) and the device engine of
``cluster_breakpoints`` against the JAX package's ``match_matrix_pallas``
and ``cluster_breakpoints(engine="pallas", interpret=True)``.

On the CPU the wrapper runs its plain PyTorch version.  Cells and cluster
memberships are exact: the tolerance is zero.  The CUDA kernel itself is
held against the plain version by the tests marked ``cuda`` (skipped
without a card) and by ``chip_smoke.py``.  This module imports JAX only
inside the tests that need it, so that on a machine with a card and no JAX
``python -m pytest --noconftest tests/test_torch_cluster.py -m cuda`` runs
the card tests.
"""
import numpy as np
import pytest
import torch

from chip_smoke import synth_breakpoints
from coral_tpu_torch.ops import breakpoints as tb
from coral_tpu_torch.ops import kernels


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _match_numpy(p1, p2, cutoff):
    a, b = np.asarray(p1, np.int64), np.asarray(p2, np.int64)
    return ((np.abs(a[:, None] - a[None, :]) < cutoff)
            & (np.abs(b[:, None] - b[None, :]) < cutoff)).astype(np.uint8)


def _fuzzed(seed):
    """A breakpoint list in the manner of ``tests/test_pallas_kernels.py``."""
    r = np.random.default_rng(seed)
    n = int(r.integers(5, 400))
    bps = []
    for _ in range(n):
        c1 = f"chr{int(r.integers(1, 4))}"
        c2 = f"chr{int(r.integers(1, 4))}"
        o1 = "+" if r.random() < 0.5 else "-"
        o2 = "+" if r.random() < 0.5 else "-"
        base1 = int(r.integers(0, 8)) * 5000
        base2 = int(r.integers(0, 8)) * 5000
        bps.append([c1, base1 + int(r.integers(0, 3000)), o1,
                    c2, base2 + int(r.integers(0, 3000)), o2,
                    ("rd", 0, 1), 0, 0, 60, 60])
    return bps


def _ids(clusters):
    return [[id(m) for m in c] for c in clusters]


@pytest.mark.parametrize("n,lo,hi,cutoff", [
    (300, 0, 10_000, 2000),         # the JAX test's shape
    (128, 0, 10_000, 2000),         # one TPU tile exactly
    (77, -5_000, 5_000, 1500),      # negative positions that do not wrap
    (1, 0, 10, 5),
    (200, 0, 50, 1),                # only equal positions match
    (200, 0, 50, 0)])               # nothing matches, not even itself
def test_match_matrix_plain_equals_pallas(n, lo, hi, cutoff):
    from coral_tpu.ops.pallas_kernels import match_matrix_pallas

    rng = np.random.default_rng(7)
    p1 = rng.integers(lo, hi, n).astype(np.int32)
    p2 = rng.integers(lo, hi, n).astype(np.int32)
    want = match_matrix_pallas(p1, p2, cutoff, interpret=True)
    got = kernels.match_matrix(_t(p1), _t(p2), cutoff)
    assert got.dtype == torch.uint8 and got.shape == (n, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _match_numpy(p1, p2, cutoff))
    if cutoff > 1:
        assert (got.numpy().diagonal() == 1).all()
    if n > 1 and cutoff > 1:
        assert 0 < got.sum() < n * n


def test_match_matrix_follows_the_host_where_int32_wraps():
    """Positions 2^31 or more apart: the TPU kernel's int32 subtraction
    wraps to a small difference and calls them a match; the port takes the
    true difference, as the host clustering does in int64."""
    from coral_tpu.ops.pallas_kernels import match_matrix_pallas

    p1 = np.array([-2**31 + 5, 2**31 - 5, 0, -2**31, 2**31 - 1], np.int32)
    p2 = np.zeros(5, np.int32)
    got = kernels.match_matrix(_t(p1), _t(p2), 100).numpy()
    np.testing.assert_array_equal(got, _match_numpy(p1, p2, 100))
    assert got[0, 1] == 0 and got[0, 3] == 1 and got[1, 4] == 1
    tpu = match_matrix_pallas(p1, p2, 100, interpret=True)
    assert tpu[0, 1] == 1            # 10 apart after the wrap


@pytest.mark.parametrize("seed", range(5))
def test_cluster_breakpoints_torch_equals_jax_pallas_and_host(seed):
    from coral_tpu.ops.breakpoints import cluster_breakpoints as jax_cluster

    bps = _fuzzed(seed)
    host = tb.cluster_breakpoints(bps, 3, 2000)
    dev = tb.cluster_breakpoints(bps, 3, 2000, engine="torch", device="cpu")
    assert _ids(dev) == _ids(host)
    assert _ids(dev) == _ids(jax_cluster(bps, 3, 2000, engine="pallas",
                                         interpret=True))
    assert _ids(host) == _ids(jax_cluster(bps, 3, 2000))
    assert sum(map(len, dev)) == len(bps)


def test_cluster_breakpoints_large_groups_and_the_cap(monkeypatch):
    """The seeded list of ``chip_smoke.py`` at a small scale: groups of a
    few hundred members through the match matrix, one group past the
    (lowered) cap through the host scan, and a group with a position
    outside int32, which also takes the host scan."""
    bps = synth_breakpoints(seed=1, group_sizes=(40, 300, 650, 900))
    bps += [["chrX", 2**31 + k, "+", "chrX", 10 * k, "-", ("r", 0, 1), 0, 0,
             60, 60] for k in range(70)]
    monkeypatch.setattr(tb, "_DEVICE_GROUP_CAP", 700)
    calls = []
    inner = kernels.match_matrix_torch
    monkeypatch.setattr(kernels, "match_matrix_torch",
                        lambda *a: calls.append(len(a[0])) or inner(*a))
    host = tb.cluster_breakpoints(bps, 3, 2000)
    dev = tb.cluster_breakpoints(bps, 3, 2000, engine="torch", device="cpu")
    assert _ids(dev) == _ids(host)
    assert sorted(calls) == [40, 300, 650]
    assert len(host) > 20 and max(map(len, host)) > 50


@pytest.mark.parametrize("bad", ["dtype", "length", "cutoff", "2d"])
def test_match_matrix_checks(bad):
    p1, p2, cutoff = _t(np.arange(8)), _t(np.arange(8)), 5
    if bad == "dtype":
        p1 = p1.to(torch.int64)
    elif bad == "length":
        p2 = p2[:-1]
    elif bad == "cutoff":
        cutoff = -1
    else:
        p1, p2 = p1.reshape(2, 4), p2.reshape(2, 4)
    with pytest.raises(ValueError):
        kernels.match_matrix(p1, p2, cutoff)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 127, 128, 129, 1000, 2048, 2050])
def test_cuda_match_matrix_equals_plain(cuda_device, n):
    rng = np.random.default_rng(n)
    p1 = rng.integers(0, 100_000, n).astype(np.int32)
    p2 = rng.integers(0, 100_000, n).astype(np.int32)
    if n >= 3:
        p1[:3] = [-2**31, 2**31 - 1, -2**31 + 50]
    a, b = _t(p1).to(cuda_device), _t(p2).to(cuda_device)
    before = kernels.LAUNCHES["match_matrix"]
    for cutoff in (0, 1, 2000, 2**31 - 1):
        got = kernels.match_matrix(a, b, cutoff)
        torch.cuda.synchronize()
        assert got.dtype == torch.uint8
        assert torch.equal(got, kernels.match_matrix_torch(a, b, cutoff))
    assert kernels.LAUNCHES["match_matrix"] == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(3))
def test_cuda_cluster_breakpoints_equals_host(cuda_device, seed):
    bps = _fuzzed(seed) + synth_breakpoints(seed=seed,
                                            group_sizes=(500, 1500))
    host = tb.cluster_breakpoints(bps, 3, 2000)
    dev = tb.cluster_breakpoints(bps, 3, 2000, engine="cuda",
                                 device=cuda_device)
    assert _ids(dev) == _ids(host)
