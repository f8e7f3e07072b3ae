"""The device half of :mod:`coral_tpu.ops.scoring`, in PyTorch.

This module is the port's ONE copy of the junction-predicate formula
(:func:`pair_predicate`); the CUDA kernels in ``csrc/pair3.cu`` evaluate
the same decision chain over the packed v3 layout and are held against
:func:`pair_predicate_packed3` bit for bit.  The host packers
(``coral_tpu.ops.scoring.pack_pairs3_host``, native
``coral_tpu.native.bamcore.pack_pairs3``) are imported from the JAX
package, never copied: the port consumes exactly the columns the TPU
kernels consume.

Differences from the JAX module, all deliberate:

* coverage prefix tables are exact int64 (``torch.sort``/``cumsum``/
  ``searchsorted``).  The JAX module keeps an int32 residue plus a
  float32 estimate and recombines them on the host (``combine_coverage``)
  only because s64 is emulated on the TPU; CUDA has native int64.
* the same-strand threshold ``max(gap_, 0.2*|qgap|)`` is evaluated in the
  float width that matches the integer columns: float64 for int64
  columns (the numpy engine and the Python reference), float32 for int32
  columns (the TPU kernels, where ``int32 * 0.2`` promotes to float32).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from coral_tpu.ops.scoring import MAX_PACKED2_INTERVALS, META3_IOG_SHIFT

from ..device import resolve_device


def as_tensor(a, device: torch.device, dtype=None) -> torch.Tensor:
    """numpy array or tensor -> contiguous tensor on ``device`` (no copy
    when it already is one)."""
    t = a if isinstance(a, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


def first_overlap(chrom, a, b, int_chrom, int_start, int_end):
    """Index of the first interval overlapping [a, b] on ``chrom``; -1 if
    none (``coral_tpu.ops.scoring.first_overlap``: the same storage-order
    test, which keeps the minus-strand r1 > r2 quirk)."""
    n_int = int_chrom.shape[0]
    if n_int == 0:
        return torch.full(chrom.shape, -1, dtype=torch.int64,
                          device=chrom.device)
    ov = (chrom[:, None] == int_chrom[None, :]) \
        & (a[:, None] <= int_end[None, :]) \
        & (int_start[None, :] <= b[:, None])
    lane = torch.arange(n_int, device=chrom.device)
    first = torch.where(ov, lane, n_int).amin(dim=1)
    return torch.where(first < n_int, first, -1)


def pair_predicate(
    # pair columns (i = left alignment, j = right alignment, query order)
    qi_end, qj_start, chrom_i, r1_i, r2_i, strand_i, mapq_i, nm_i,
    chrom_j, r1_j, r2_j, strand_j, mapq_j, nm_j,
    # interval table (padded rows with chrom code -2 are inert)
    int_chrom, int_start, int_end,
    # scalars
    min_bp_match_cutoff, min_mapq, gap_, max_nm,
    first_overlap_fn=None,
):
    """The interval-list junction predicate on tensors
    (``coral_tpu.ops.scoring.pair_predicate``, reference
    ``alignment2bp_l``).  Returns ``(hit, io)``; pass zero ``nm_*`` and
    ``max_nm=inf`` to switch the NM gate off."""
    fo = first_overlap if first_overlap_fn is None else first_overlap_fn
    io_i = fo(chrom_i, r1_i, r2_i, int_chrom, int_start, int_end)
    io_j = fo(chrom_j, r1_j, r2_j, int_chrom, int_start, int_end)
    qgap = qj_start - qi_end
    base = (qgap + min_bp_match_cutoff >= 0) & (io_i >= 0) & (io_i == io_j)
    mq_ok = (mapq_i >= min_mapq) & (mapq_j >= min_mapq)
    nm_ok = (nm_i < max_nm) & (nm_j < max_nm)
    strand_diff = strand_i != strand_j
    # same-strand clause (reference :150-161): reference jump between the
    # facing endpoints vs the read gap ('-' reads store r1 > r2)
    grr = torch.where(strand_j > 0, r1_j - r2_i, r2_i - r1_j)
    ft = torch.float64 if qgap.dtype == torch.int64 else torch.float32
    gap_disc = (qgap - grr).abs().to(ft) \
        > torch.clamp(qgap.abs().to(ft) * 0.2, min=gap_)
    hit = base & mq_ok & nm_ok & (strand_diff | gap_disc)
    return hit, io_i


def unpack_pair_meta3(meta):
    """Inverse of the v3 meta word: -> (iogm, strand_diff)."""
    return (meta >> META3_IOG_SHIFT) - 1, meta & 1


def pair_predicate_packed3(qgap, grr, meta, min_bp_match_cutoff, gap_):
    """:func:`pair_predicate` over the resolved 3-column v3 layout, with
    the substitutions of ``coral_tpu.ops.scoring.pair_predicate_packed3``
    (gate injected as the interval search, strands fed so that their
    difference is the packed bit, ``grr`` fed as the reference jump, MAPQ
    and NM gates passed through).  Returns (hit, iogm)."""
    iogm, sdiff = unpack_pair_meta3(meta)
    zero_i = torch.zeros_like(qgap)
    zero_f = torch.zeros(qgap.shape, dtype=torch.float32, device=qgap.device)
    one_i = torch.ones_like(qgap)
    strand_i = torch.where(sdiff > 0, -one_i, one_i)
    mq = 255
    dummy = zero_i[:1]
    return pair_predicate(
        zero_i, qgap, zero_i, zero_i, zero_i, strand_i, mq, zero_f,
        zero_i, grr, zero_i, one_i, mq, zero_f,
        dummy, dummy, dummy,
        min_bp_match_cutoff, 0, gap_, math.inf,
        first_overlap_fn=lambda *_: iogm)


def coverage_prefix_tables(starts, ends):
    """Sorted-endpoint prefix tables for exact interval coverage,
    P(x) = sum_r clip(x - rs_r, 0, re_r - rs_r), all int64."""
    s = torch.sort(starts.to(torch.int64)).values
    e = torch.sort(ends.to(torch.int64)).values
    zero = torch.zeros(1, dtype=torch.int64, device=s.device)
    return (s, e, torch.cat([zero, torch.cumsum(s, 0)]),
            torch.cat([zero, torch.cumsum(e, 0)]))


def coverage_prefix_eval(tables, xs):
    """Exact int64 P(x) per query position."""
    s, e, s_cum, e_cum = tables
    x = xs.to(torch.int64)
    n_s = torch.searchsorted(s, x, right=True)
    n_e = torch.searchsorted(e, x, right=True)
    return (x * n_s - s_cum[n_s]) - (x * n_e - e_cum[n_e])


class ScoringState(NamedTuple):
    """What crosses from the JAX package into the port: the interval
    table and the packed v3 columns, as tensors on one device."""
    int_chrom: torch.Tensor   # int32 (n_int,)
    int_start: torch.Tensor   # int64 (n_int,)
    int_end: torch.Tensor     # int64 (n_int,)
    packed3: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # int32 (n,)


def state_from_numpy(int_chrom, int_start, int_end, packed3, *,
                     device) -> ScoringState:
    """The JAX package's numpy interval table and v3 columns
    (``PACKED3_COL_ORDER``) -> the port's tensors on ``device``."""
    dev = resolve_device(device)
    return ScoringState(
        as_tensor(int_chrom, dev, torch.int32),
        as_tensor(int_start, dev, torch.int64),
        as_tensor(int_end, dev, torch.int64),
        tuple(as_tensor(c, dev, torch.int32) for c in packed3))


def make_batch_scorer(int_chrom, int_start, int_end, engine: str = "torch",
                      *, device, **scalars):
    """Product-shaped scorer (``coral_tpu.ops.scoring.make_batch_scorer_jax``):
    coverage tables build once per read batch, and each call scores one
    batch of pairs into per-interval support counts plus exact int64
    coverage per interval.

    ``engine='torch'``: ``score(tables, *14 COL_ORDER columns)`` with the
    plain predicate and ``torch.bincount``.  ``engine='cuda'``:
    ``score(tables, qgap, grr, meta)`` over the v3 layout with the fused
    predicate + histogram kernel (K2); it has no NM gate and takes at most
    ``MAX_PACKED2_INTERVALS`` intervals.

    Returns (build_tables, score); ``score`` -> (support int32, cov int64).
    """
    dev = resolve_device(device)
    ic = as_tensor(int_chrom, dev, torch.int32)
    is_ = as_tensor(int_start, dev, torch.int64)
    ie = as_tensor(int_end, dev, torch.int64)
    n_int = int(ic.shape[0])
    params = {**dict(min_bp_match_cutoff=100, min_mapq=20, gap_=100.0,
                     max_nm=math.inf), **scalars}

    def build_tables(starts, ends):
        return coverage_prefix_tables(as_tensor(starts, dev),
                                      as_tensor(ends, dev))

    def cov(tables):
        return coverage_prefix_eval(tables, ie) \
            - coverage_prefix_eval(tables, is_)

    if engine == "cuda":
        if not math.isinf(params["max_nm"]):
            raise ValueError("engine='cuda' has no NM gate")
        if n_int > MAX_PACKED2_INTERVALS:
            raise NotImplementedError(
                f"{n_int} intervals exceed the v3 layout's "
                f"{MAX_PACKED2_INTERVALS}; that needs K3/K4 (_pair_kernel, "
                "_pair_hist_kernel), which are not ported yet")
        from .kernels import pair3_support

        def score(tables, qgap, grr, meta):
            support = pair3_support(
                *(as_tensor(c, dev, torch.int32) for c in (qgap, grr, meta)),
                n_int, params["min_bp_match_cutoff"], params["gap_"])
            return support, cov(tables)

        return build_tables, score
    if engine != "torch":
        raise ValueError(f"unknown engine {engine!r} (torch or cuda)")

    def score(tables, *cols):
        hit, io = pair_predicate(*(as_tensor(c, dev) for c in cols),
                                 ic, is_, ie, **params)
        support = torch.bincount(io[hit], minlength=n_int)[:n_int]
        return support.to(torch.int32), cov(tables)

    return build_tables, score
