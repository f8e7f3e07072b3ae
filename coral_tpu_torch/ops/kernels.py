"""The hand-written CUDA kernels of the main path, each beside its plain
PyTorch version (the counterpart of ``coral_tpu/ops/pallas_kernels.py``
for K1 and K2).

A wrapper takes the plain version only for tensors on the CPU.  For a
CUDA tensor it launches its kernel (``csrc/pair3.cu``, built on first use
by :mod:`._build`) or raises; it never falls back.  :data:`LAUNCHES`
counts kernel launches, so a run can show that it went through them.

Both kernels stream 12 B per pair of the packed v3 layout
(``coral_tpu.ops.scoring.PACKED3_COL_ORDER``) and are bound by device
memory bandwidth.
"""
from __future__ import annotations

import torch

from coral_tpu.ops.scoring import MAX_PACKED2_INTERVALS

from .scoring import pair_predicate_packed3

LAUNCHES = {"pair3": 0, "pair3_support": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_cols(qgap, grr, meta) -> int:
    cols = (qgap, grr, meta)
    n = qgap.shape[0] if qgap.dim() == 1 else -1
    for t in cols:
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] != n:
            raise ValueError("qgap, grr, meta must be 1-D int32 tensors of "
                             "one length")
        if not t.is_contiguous():
            raise ValueError("qgap, grr, meta must be contiguous")
        if t.device != qgap.device:
            raise ValueError("qgap, grr, meta must be on one device")
    if qgap.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {qgap.device}")
    return n


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def pair3_hitmask_torch(qgap, grr, meta, cutoff: int, gap_: float):
    """Plain version of K1: the v3 hit mask, bool (n,)."""
    return pair_predicate_packed3(qgap, grr, meta, cutoff, gap_)[0]


def pair3_support_torch(qgap, grr, meta, n_int: int, cutoff: int,
                        gap_: float):
    """Plain version of K2: per-interval support counts, int32 (n_int,).
    Gate indices past ``n_int`` are dropped, as the TPU kernel drops them."""
    hit, iogm = pair_predicate_packed3(qgap, grr, meta, cutoff, gap_)
    counts = torch.bincount(iogm[hit], minlength=n_int)[:n_int]
    return counts.to(torch.int32)


def pair3_hitmask(qgap, grr, meta, cutoff: int, gap_: float):
    """K1 (replaces ``_pair3_kernel``, ``coral_tpu/ops/pallas_kernels.py``):
    the hit mask of each packed v3 pair, bool (n,)."""
    n = _check_cols(qgap, grr, meta)
    if qgap.device.type == "cpu":
        return pair3_hitmask_torch(qgap, grr, meta, cutoff, gap_)
    out = torch.empty(n, dtype=torch.bool, device=qgap.device)
    if n == 0:
        return out
    from . import _build

    lib = _build.load()
    rc = lib.coral_pair3_hitmask(
        qgap.data_ptr(), grr.data_ptr(), meta.data_ptr(), out.data_ptr(),
        n, int(cutoff), float(gap_), qgap.device.index or 0, _stream(qgap))
    _build.check(lib, rc, "pair3_hitmask launch")
    LAUNCHES["pair3"] += 1
    return out


def pair3_support(qgap, grr, meta, n_int: int, cutoff: int, gap_: float):
    """K2 (replaces ``_pair_hist3_kernel``): the v3 predicate fused with
    the per-interval support histogram, int32 (n_int,)."""
    n = _check_cols(qgap, grr, meta)
    if not 1 <= n_int <= MAX_PACKED2_INTERVALS:
        raise ValueError(f"n_int={n_int} outside 1..{MAX_PACKED2_INTERVALS}")
    if qgap.device.type == "cpu":
        return pair3_support_torch(qgap, grr, meta, n_int, cutoff, gap_)
    out = torch.zeros(n_int, dtype=torch.int32, device=qgap.device)
    if n == 0:
        return out
    from . import _build

    lib = _build.load()
    rc = lib.coral_pair3_support(
        qgap.data_ptr(), grr.data_ptr(), meta.data_ptr(), out.data_ptr(),
        n, int(n_int), int(cutoff), float(gap_), qgap.device.index or 0,
        _stream(qgap))
    _build.check(lib, rc, "pair3_support launch")
    LAUNCHES["pair3_support"] += 1
    return out
