"""The port's fused scoring step (``coral_tpu_torch.ops.scoring``:
``make_fused_step``, ``make_fused_step_numpy``) against the JAX package's
``make_fused_step_jax`` and ``make_fused_step_numpy``.

Support counts are integers and coverage is exact int64 on both sides
(the JAX step recombines its int32 residue and float32 estimate), so the
tolerance is zero, coverage past 2^31 included.  The ``cuda`` engine packs
the columns and runs K4; on the CPU its wrapper runs K4's plain version,
and the tests marked ``cuda`` run the kernel.  This module imports JAX
only inside the tests that need it, so that on a machine with a card and
no JAX ``python -m pytest --noconftest tests/test_torch_fused_step.py -m
cuda`` runs the card tests.
"""
import math

import numpy as np
import pytest
import torch

from chip_smoke import dense_case6
from coral_tpu_torch.ops import kernels
from coral_tpu_torch.ops.scoring import (COL_ORDER, make_fused_step,
                                         make_fused_step_numpy,
                                         unpack_pair_meta_np)

INT32_MAX = np.iinfo(np.int32).max


def _graft(n_int, seed=0):
    """``__graft_entry__._synthetic_batch`` (the step's own compile-check
    shapes: 256 reads, 255 pairs) over ``n_int`` intervals."""
    from __graft_entry__ import _synthetic_batch

    starts, ends, cols, ic, is_, ie = _synthetic_batch(
        n_intervals=n_int, seed=seed)
    return starts, ends, [cols[k] for k in COL_ORDER], (ic, is_, ie)


def _dense(n_pairs, n_int, seed, long_reads=False, n_reads=2048):
    """``chip_smoke.dense_case6``'s pairs (about a fifth hit, threshold
    and wrap edges included) as the 14 unpacked columns, NM per base drawn
    in [0, 0.2), with read spans; ``long_reads`` makes every read cover
    the windows, so that coverage passes 2^31."""
    rng = np.random.default_rng(seed)
    table, packed = dense_case6(n_pairs, n_int, seed)
    qgap, r1_i, r2_i, r1_j, r2_j, meta = packed
    ci, si, mi, cj, sj, mj = unpack_pair_meta_np(meta)
    zero = np.zeros(n_pairs, np.int32)
    cols = dict(qi_end=zero, qj_start=qgap, chrom_i=ci, r1_i=r1_i,
                r2_i=r2_i, strand_i=si, mapq_i=mi,
                nm_i=(rng.random(n_pairs) * 0.2).astype(np.float32),
                chrom_j=cj, r1_j=r1_j, r2_j=r2_j, strand_j=sj, mapq_j=mj,
                nm_j=(rng.random(n_pairs) * 0.2).astype(np.float32))
    if long_reads:
        starts = rng.integers(0, 1_000, n_reads)
        ends = rng.integers(400_000_000, 500_000_000, n_reads)
    else:
        starts = rng.integers(0, 140_000_000, n_reads)
        ends = starts + rng.integers(1_000, 60_000, n_reads)
    return (starts.astype(np.int32), ends.astype(np.int32),
            [np.asarray(cols[k]) for k in COL_ORDER], table)


CASES = {
    "graft, 4 intervals": lambda: _graft(4),
    "graft, 16 intervals": lambda: _graft(16, seed=1),
    "graft, 8,200 intervals": lambda: _graft(8200, seed=2),
    "dense, 16 intervals": lambda: _dense(2048, 16, 3),
    "dense, 8,200 intervals": lambda: _dense(2048, 8200, 4),
    "long reads, 16 intervals": lambda: _dense(1024, 16, 5, True, 8192),
    "long reads, 8,200 intervals": lambda: _dense(1024, 8200, 6, True, 8192),
}


@pytest.mark.parametrize("max_nm", [math.inf, 0.1], ids=["nm off", "nm on"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_step_matches_jax(case, max_nm):
    from coral_tpu.ops import scoring as js

    starts, ends, cols, table = CASES[case]()
    want_s, want_c = js.make_fused_step_jax(*table, max_nm=max_nm)(
        starts, ends, *cols)
    want_sn, want_cn = js.make_fused_step_numpy(*table, max_nm=max_nm)(
        starts, ends, *cols)
    got_s, got_c = make_fused_step(*table, "torch", device="cpu",
                                   max_nm=max_nm)(starts, ends, *cols)
    got_sn, got_cn = make_fused_step_numpy(*table, max_nm=max_nm)(
        starts, ends, *cols)
    assert got_s.dtype == torch.int32 and got_c.dtype == torch.int64
    assert got_sn.dtype == np.int32 and got_cn.dtype == np.int64
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    np.testing.assert_array_equal(got_sn, want_sn)
    np.testing.assert_array_equal(got_cn, want_cn)
    np.testing.assert_array_equal(got_sn, got_s.numpy())
    np.testing.assert_array_equal(got_cn, got_c.numpy())
    if case.startswith("long reads"):
        assert got_cn.max() > INT32_MAX
    if case.startswith("dense"):
        assert got_sn.sum() > 100


@pytest.mark.parametrize("n_int", [16, 64, 65, 8200])
def test_cuda_engine_packs_for_k4(n_int):
    """On CPU tensors K4's wrapper runs its plain version: the packed
    6-column route equals the 14-column step."""
    starts, ends, cols, table = _dense(2048, n_int, n_int)
    want = make_fused_step(*table, "torch", device="cpu")(starts, ends,
                                                          *cols)
    got = make_fused_step(*table, "cuda", device="cpu")(starts, ends, *cols)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_cuda_engine_has_no_nm_gate():
    _, _, _, table = _graft(4)
    with pytest.raises(ValueError, match="NM gate"):
        make_fused_step(*table, "cuda", device="cpu", max_nm=0.1)


def test_step_rejects_what_it_cannot_run():
    starts, ends, cols, table = _graft(4)
    with pytest.raises(ValueError, match="unknown engine"):
        make_fused_step(*table, "cuda6", device="cpu")
    with pytest.raises(ValueError, match="COL_ORDER"):
        make_fused_step(*table, device="cpu")(starts, ends, *cols[:-1])


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, _, _, table = _graft(4)
    with pytest.raises(RuntimeError, match="cuda"):
        make_fused_step(*table, "cuda", device="cuda")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("n_int", [16, 64, 65, 8200])
def test_k4_route_on_the_card(cuda, n_int):
    """K4 on the card == the ``torch`` engine on the card, a launch a
    step, the interval index built once a step factory above 64."""
    starts, ends, cols, table = _dense(1 << 16, n_int, n_int)
    want = make_fused_step(*table, "torch", device=cuda)(starts, ends,
                                                         *cols)
    kernels.reset_launches()
    step = make_fused_step(*table, "cuda", device=cuda)
    for _ in range(2):
        got = step(starts, ends, *cols)
        for a, b in zip(got, want):
            assert a.is_cuda and torch.equal(a, b)
    assert kernels.LAUNCHES["pair6_support"] == 2
    assert kernels.LAUNCHES["interval_index"] == \
        (1 if n_int > kernels.PAIR6_SCAN_MAX_INTERVALS else 0)
