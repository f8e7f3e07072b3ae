"""K1 / K2 of the port (``coral_tpu_torch.ops.kernels``) against the
Pallas kernels they replace.

On the CPU the wrappers run their plain PyTorch versions, which are held
here against ``pair_predicates_pallas_packed3`` and
``make_pair_hist3_pallas_fn`` in interpret mode (and numpy), bit for bit:
masks and counts are integers, so the tolerance is zero.  The CUDA
kernels themselves are held against the plain versions by the tests
marked ``cuda`` (skipped without a card) and by ``chip_smoke.py``.  This
module imports JAX only inside the tests that need it, so that on a
machine with a card and no JAX
``python -m pytest --noconftest tests/test_torch_kernels.py -m cuda``
runs the card tests.
"""
import numpy as np
import pytest
import torch

from coral_tpu.ops.layout import LANES
from coral_tpu.ops.scoring import pair_predicate_packed3 as np_predicate
from coral_tpu_torch.ops import kernels
from coral_tpu_torch.ops.scoring import state_from_numpy

CUTOFF = 100
GAP = 100.0
ROWS = 16                 # 16 x 128 pairs: interpret-mode Pallas stays fast
N = ROWS * LANES


def _case(kind: str, n: int = N, n_int: int = 16, seed: int = 0):
    """Packed v3 columns (qgap, grr, meta), int32.

    dense: about half the rows hit; edge: |qgap| a multiple of 5 with
    |qgap - grr| = |qgap|/5 and +-1, qgap = -cutoff and -cutoff-1; pad:
    zero rows among live ones; wrap: int32 extremes, where the int32
    arithmetic of the TPU kernel wraps."""
    rng = np.random.default_rng(seed)
    qgap = rng.integers(-300, 200_000, n).astype(np.int64)
    grr = qgap + rng.integers(-60_000, 60_000, n)
    iogm = rng.integers(-n_int // 3, n_int, n)
    sdiff = rng.integers(0, 2, n)
    if kind == "edge":
        q = 5 * rng.integers(101, 200_000, n) * rng.choice([-1, 1], n)
        qgap = q
        grr = q - np.sign(q) * (np.abs(q) // 5 + rng.integers(-1, 2, n)) \
            * rng.choice([-1, 1], n)
        sdiff[:] = 0
        iogm = rng.integers(0, n_int, n)
        k = n // 4
        qgap[:k] = -CUTOFF - rng.integers(0, 2, k)
        sdiff[:k] = 1
    elif kind == "wrap":
        ext = np.array([-2**31, -2**31 + 1, -2**31 + 99, 2**31 - 1,
                        2**31 - 100, 2**31 - 101, -1, 0], np.int64)
        qgap = rng.choice(ext, n)
        grr = rng.choice(ext, n)
    meta = ((iogm + 1) << 1) | sdiff
    if kind == "pad":
        meta[rng.random(n) < 0.3] = 0
    return [qgap.astype(np.int32), grr.astype(np.int32),
            meta.astype(np.int32)]


def _cpu(cols):
    return [torch.from_numpy(c) for c in cols]


@pytest.mark.parametrize("kind", ["dense", "edge", "pad", "wrap"])
def test_hitmask_plain_equals_pallas(kind):
    from coral_tpu.ops.pallas_kernels import pair_predicates_pallas_packed3

    packed = _case(kind)
    want = pair_predicates_pallas_packed3(packed, N, CUTOFF, GAP,
                                          interpret=True)
    got = kernels.pair3_hitmask(*_cpu(packed), CUTOFF, GAP)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    if kind != "wrap":
        # numpy's threshold is float64; it agrees wherever |qgap| < 2^24
        np.testing.assert_array_equal(
            got.numpy(), np_predicate(np, *packed, CUTOFF, GAP)[0])
    if kind == "dense":
        assert 0.3 < want.mean() < 0.7
    if kind == "edge":
        assert want.any() and not want.all()


@pytest.mark.parametrize("n_int", [1, 16])
@pytest.mark.parametrize("kind", ["dense", "edge", "pad", "wrap"])
def test_support_plain_equals_pallas(kind, n_int):
    from coral_tpu.ops.pallas_kernels import make_pair_hist3_pallas_fn

    packed = _case(kind, n_int=16)
    fn = make_pair_hist3_pallas_fn(ROWS, n_int, CUTOFF, GAP, interpret=True)
    want = np.asarray(fn(*[c.reshape(ROWS, LANES) for c in packed]))[0]
    got = kernels.pair3_support(*_cpu(packed), n_int, CUTOFF, GAP)
    assert got.dtype == torch.int32 and got.shape == (n_int,)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "dense":
        assert want.sum() > 0


def test_support_max_intervals_equals_bincount():
    """n_int = 8190 (the v3 layout's limit) on a few rows, against numpy:
    the Pallas kernel unrolls one loop step per bin, too slow to trace
    at this width in interpret mode."""
    n_int = 8190
    packed = _case("dense", n=64, n_int=n_int, seed=3)
    packed[2][:4] = ((np.array([0, 8189, 8189, 17]) + 1) << 1) | 1
    got = kernels.pair3_support(*_cpu(packed), n_int, CUTOFF, GAP)
    hit, iogm = np_predicate(np, *packed, CUTOFF, GAP)
    np.testing.assert_array_equal(
        got.numpy(), np.bincount(iogm[hit], minlength=n_int))
    assert got[8189] >= 2


def test_cpu_wrappers_do_not_launch():
    before = dict(kernels.LAUNCHES)
    cols = _cpu(_case("dense"))
    kernels.pair3_hitmask(*cols, CUTOFF, GAP)
    kernels.pair3_support(*cols, 16, CUTOFF, GAP)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "length", "strided", "n_int"])
def test_wrapper_checks(bad):
    q, g, m = _cpu(_case("dense"))
    n_int = 16
    if bad == "dtype":
        q = q.to(torch.int64)
    elif bad == "length":
        g = g[:-1]
    elif bad == "strided":
        q, g, m = q[::2], g[::2], m[::2]
    else:
        n_int = 8191
    with pytest.raises(ValueError):
        kernels.pair3_support(q, g, m, n_int, CUTOFF, GAP)
    if bad != "n_int":
        with pytest.raises(ValueError):
            kernels.pair3_hitmask(q, g, m, CUTOFF, GAP)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "edge", "pad", "wrap"])
def test_cuda_kernels_equal_plain(cuda_device, kind):
    packed = _case(kind, n=N * 64 + 3)   # a tail past the 4-wide loop
    st = state_from_numpy(np.zeros(1), np.zeros(1), np.zeros(1), packed,
                          device=cuda_device)
    launches = dict(kernels.LAUNCHES)
    hit = kernels.pair3_hitmask(*st.packed3, CUTOFF, GAP)
    sup = kernels.pair3_support(*st.packed3, 16, CUTOFF, GAP)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pair3"] == launches["pair3"] + 1
    assert kernels.LAUNCHES["pair3_support"] == \
        launches["pair3_support"] + 1
    assert torch.equal(hit, kernels.pair3_hitmask_torch(*st.packed3,
                                                        CUTOFF, GAP))
    assert torch.equal(sup, kernels.pair3_support_torch(*st.packed3, 16,
                                                        CUTOFF, GAP))
    # an unaligned view takes the scalar loop
    off = [c[1:] for c in st.packed3]
    assert torch.equal(kernels.pair3_hitmask(*off, CUTOFF, GAP),
                       kernels.pair3_hitmask_torch(*off, CUTOFF, GAP))
    assert torch.equal(kernels.pair3_support(*off, 16, CUTOFF, GAP),
                       kernels.pair3_support_torch(*off, 16, CUTOFF, GAP))
