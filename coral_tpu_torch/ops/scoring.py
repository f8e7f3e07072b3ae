"""The breakpoint-pair scoring math of the port: the counterpart of
``coral_tpu/ops/scoring.py``, in two halves.

**Host half (numpy).**  The packed pair layouts and their packers
(:func:`pack_pair_cols`, :func:`pack_pair_cols2`, :func:`pack_pairs2_host`,
:func:`pack_pairs3_host`, the twins of the native ``bamcore`` packers), and
the junction predicate on numpy arrays (:func:`pair_predicate_np` and its
packed forms), which is the ``numpy`` engine.  These are the JAX package's functions with
``xp=numpy`` written in; the port carries its own copy so that it loads
without that package.

**Tensor half (PyTorch).**  :func:`pair_predicate` and its packed forms on
tensors: the ``torch`` engine, and the plain versions the CUDA kernels in
``csrc/`` are held against bit for bit.

Differences from the JAX module, all deliberate:

* coverage prefix tables are exact int64 (``torch.sort``/``cumsum``/
  ``searchsorted``).  The JAX module keeps an int32 residue plus a
  float32 estimate and recombines them on the host (``combine_coverage``)
  only because s64 is emulated on the TPU; CUDA has native int64.
* the same-strand threshold ``max(gap_, 0.2*|qgap|)`` of the tensor half
  is evaluated in the float width that matches the integer columns:
  float64 for int64 columns (the numpy engine and the Python reference),
  float32 for int32 columns (the TPU kernels, where ``int32 * 0.2``
  promotes to float32).
* the tensor :func:`first_overlap` walks the pairs in chunks, so that the
  (pairs, intervals) mask stays small at thousands of intervals.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device

# --- the packed pair layouts (coral_tpu/ops/scoring.py) --------------------
#
# 6-column layout: qgap, the four reference ends, and one meta word
#   meta: [ side_i : 14 bits | side_j : 14 bits ]  (4 spare high bits)
#   side: [ chrom+1 : 5 bits | mapq : 8 bits | strand>0 : 1 bit ]
META_SIDE_BITS = 14
META_CHROM_SHIFT = 9
META_MAPQ_SHIFT = 1
PACKED_COL_ORDER = ("qgap", "r1_i", "r2_i", "r1_j", "r2_j", "meta")
# the 14-column unpacked layout, in pair_predicate's parameter order
COL_ORDER = ("qi_end", "qj_start", "chrom_i", "r1_i", "r2_i", "strand_i",
             "mapq_i", "nm_i", "chrom_j", "r1_j", "r2_j", "strand_j",
             "mapq_j", "nm_j")
# v2, interval gate resolved at pack time: qgap, r2_i, r1_j and
#   meta2: [ 0 : 1 | iog+1 : 13 | mapq_i : 8 | strand_i>0 : 1
#                  | mapq_j : 8 | strand_j>0 : 1 ]
META2_IOG_SHIFT = 18
META2_MAPQ_I_SHIFT = 10
META2_STRAND_I_SHIFT = 9
META2_MAPQ_J_SHIFT = 1
PACKED2_COL_ORDER = ("qgap", "r2_i", "r1_j", "meta")
MAX_PACKED2_INTERVALS = (1 << 13) - 2  # iog+1 must fit 13 bits
# v3, interval and MAPQ gates resolved and the reference jump pre-derived:
#   meta3: [ iogm+1 : 13 bits | strand_diff : 1 ]
META3_IOG_SHIFT = 1
PACKED3_COL_ORDER = ("qgap", "grr", "meta")


# --- host half: numpy ------------------------------------------------------

def first_overlap_np(chrom, a, b, int_chrom, int_start, int_end):
    """Index of the first interval overlapping [a, b] on ``chrom``; -1 if
    none.  Storage-order overlap test (r1 > r2 on '-' strand rows is kept,
    as ``interval_overlap`` does in the reference)."""
    ov = (chrom[:, None] == int_chrom[None, :]) \
        & (a[:, None] <= int_end[None, :]) \
        & (int_start[None, :] <= b[:, None])
    return np.where(np.any(ov, axis=1), np.argmax(ov, axis=1), -1)


def pair_predicate_np(
    qi_end, qj_start, chrom_i, r1_i, r2_i, strand_i, mapq_i, nm_i,
    chrom_j, r1_j, r2_j, strand_j, mapq_j, nm_j,
    int_chrom, int_start, int_end,
    min_bp_match_cutoff, min_mapq, gap_, max_nm,
    first_overlap_fn=None,
):
    """The interval-list junction predicate on numpy arrays
    (``coral_tpu.ops.scoring.pair_predicate`` with ``xp=numpy``; reference
    ``alignment2bp_l``).  Returns ``(hit, io)``: ``hit`` marks pairs
    forming a breakpoint and ``io`` the first interval of side i (-1 when
    none).  Pass zero ``nm_*`` and ``max_nm=inf`` to switch the NM gate
    off."""
    fo = first_overlap_np if first_overlap_fn is None else first_overlap_fn
    io_i = fo(chrom_i, r1_i, r2_i, int_chrom, int_start, int_end)
    io_j = fo(chrom_j, r1_j, r2_j, int_chrom, int_start, int_end)
    qgap = qj_start - qi_end
    base = (qgap + min_bp_match_cutoff >= 0) & (io_i >= 0) & (io_i == io_j)
    mq_ok = (mapq_i >= min_mapq) & (mapq_j >= min_mapq)
    nm_ok = (nm_i < max_nm) & (nm_j < max_nm)
    strand_diff = strand_i != strand_j
    # same-strand clause (reference :150-161): reference jump between the
    # facing endpoints vs the read gap; '+' reads jump r1_j - r2_i,
    # '-' reads jump r2_i - r1_j (storage order keeps r1 > r2 on '-').
    grr = np.where(strand_j > 0, r1_j - r2_i, r2_i - r1_j)
    gap_disc = np.abs(qgap - grr) > np.maximum(gap_, np.abs(qgap) * 0.2)
    hit = base & mq_ok & nm_ok & (strand_diff | gap_disc)
    return hit, io_i


def _int32(a):
    """numpy array or tensor -> int32, integers wrapping to their low 32
    bits."""
    return a.to(torch.int32) if isinstance(a, torch.Tensor) \
        else a.astype(np.int32)


def pack_pair_cols(qi_end, qj_start, chrom_i, r1_i, r2_i, strand_i,
                   mapq_i, chrom_j, r1_j, r2_j, strand_j, mapq_j):
    """Pack the 12 predicate columns (numpy arrays, or tensors on one
    device) into the 6-column layout (:data:`PACKED_COL_ORDER`), the host
    twin of the native ``bamcore.pack_pairs``.  ``chrom`` is a CHR_IDX
    code (-1 = unknown, stored +1); ``mapq`` clamps to the BAM uint8
    domain so that an unvalidated SA-tag value cannot overflow into the
    chrom field; ``strand`` is +1/-1.  There is no NM slot: the packed
    routes exist for ``max_nm=inf``."""
    def side(chrom, strand, mapq):
        return ((_int32(chrom) + 1) << META_CHROM_SHIFT) \
            | (_int32(mapq).clip(0, 255) << META_MAPQ_SHIFT) \
            | _int32(strand > 0)

    meta = (side(chrom_i, strand_i, mapq_i) << META_SIDE_BITS) \
        | side(chrom_j, strand_j, mapq_j)
    return (_int32(qj_start - qi_end), _int32(r1_i), _int32(r2_i),
            _int32(r1_j), _int32(r2_j), meta)


def _unpack_sides(meta, sign):
    """The meta word -> (chrom_i, strand_i, mapq_i, chrom_j, strand_j,
    mapq_j); ``sign`` maps the strand bit to +1/-1 in the caller's array
    type."""
    def side(v):
        return ((v >> META_CHROM_SHIFT) - 1, sign(v & 1),
                (v >> META_MAPQ_SHIFT) & 0xFF)

    return (*side(meta >> META_SIDE_BITS),
            *side(meta & ((1 << META_SIDE_BITS) - 1)))


def unpack_pair_meta_np(meta):
    """Inverse of the meta word on numpy arrays, strands as +1/-1 int32."""
    return _unpack_sides(
        meta, lambda bit: np.where(bit > 0, 1, -1).astype(np.int32))


def pair_predicate_packed_np(qgap, r1_i, r2_i, r1_j, r2_j, meta,
                             int_chrom, int_start, int_end,
                             min_bp_match_cutoff, min_mapq, gap_):
    """:func:`pair_predicate_np` over the packed 6-column layout
    (``qi_end=0, qj_start=qgap``: only the difference is used; inert NM
    columns)."""
    ci, si, mi, cj, sj, mj = unpack_pair_meta_np(meta)
    zero_i = np.zeros_like(qgap)
    zero_f = np.zeros(qgap.shape, np.float32)
    return pair_predicate_np(
        zero_i, qgap, ci, r1_i, r2_i, si, mi, zero_f,
        cj, r1_j, r2_j, sj, mj, zero_f,
        int_chrom, int_start, int_end,
        min_bp_match_cutoff, min_mapq, gap_, np.inf)


def combine_interval_gate(io_i, io_j):
    """The pair's combined interval gate (numpy):
    ``io_i if io_i >= 0 and io_i == io_j else -1``."""
    return np.where((io_i >= 0) & (io_i == io_j), io_i,
                    np.full_like(io_i, -1))


def _alignment_gate(pi, chrom, r1, r2, int_chrom, int_start, int_end):
    """Combined interval gate of the pairs (pi[p], pi[p]+1), with the
    interval search done once per ALIGNMENT."""
    io = first_overlap_np(np.asarray(chrom), np.asarray(r1), np.asarray(r2),
                          np.asarray(int_chrom), np.asarray(int_start),
                          np.asarray(int_end))
    return combine_interval_gate(io[pi], io[pi + 1])


def _zero_pad(packed, n_pairs: int, n_out: Optional[int]):
    """Rows [n_pairs, n_out) zero (meta 0 never hits)."""
    if n_out is None or n_out == n_pairs:
        return list(packed)
    out = []
    for c in packed:
        padded = np.zeros(n_out, np.int32)
        padded[:n_pairs] = c
        out.append(padded)
    return out


def pack_pairs2_host(pi, q_start, q_end, r1, r2, chrom, strand, mapq,
                     int_chrom, int_start, int_end,
                     n_out: Optional[int] = None):
    """Host (numpy) emission of the v2 layout (:data:`PACKED2_COL_ORDER`)
    from flat ALIGNMENT columns for pairs (pi[p], pi[p]+1): the twin of
    the native ``bamcore.pack_pairs2``, bit-identical by test."""
    pj = pi + 1
    iog = _alignment_gate(pi, chrom, r1, r2, int_chrom, int_start, int_end)
    st, mq = np.asarray(strand), np.asarray(mapq)
    return _zero_pad(
        pack_pair_cols2(q_end[pi], q_start[pj], r2[pi], st[pi], mq[pi],
                        r1[pj], st[pj], mq[pj], iog),
        len(pi), n_out)


def pack_pair_cols2(qi_end, qj_start, r2_i, strand_i, mapq_i,
                    r1_j, strand_j, mapq_j, iog):
    """Pack interval-resolved pair columns (numpy) into the 4-column v2
    layout (:data:`PACKED2_COL_ORDER`).  ``iog`` is the combined gate of
    :func:`combine_interval_gate`; MAPQ clamps to the BAM uint8 domain as
    in :func:`pack_pair_cols`."""
    i32 = np.int32
    mi = np.clip(mapq_i.astype(i32), 0, 255)
    mj = np.clip(mapq_j.astype(i32), 0, 255)
    qgap = (qj_start - qi_end).astype(i32)
    meta = ((iog.astype(i32) + 1) << META2_IOG_SHIFT) \
        | (mi << META2_MAPQ_I_SHIFT) \
        | ((strand_i > 0).astype(i32) << META2_STRAND_I_SHIFT) \
        | (mj << META2_MAPQ_J_SHIFT) \
        | (strand_j > 0).astype(i32)
    return qgap, r2_i.astype(i32), r1_j.astype(i32), meta


def _unpack_meta2(meta, sign):
    """The meta2 word -> (iog, strand_i, mapq_i, strand_j, mapq_j);
    ``sign`` maps a strand bit to +1/-1 in the caller's array type."""
    return (((meta >> META2_IOG_SHIFT) & 0x1FFF) - 1,
            sign((meta >> META2_STRAND_I_SHIFT) & 1),
            (meta >> META2_MAPQ_I_SHIFT) & 0xFF,
            sign(meta & 1),
            (meta >> META2_MAPQ_J_SHIFT) & 0xFF)


def unpack_pair_meta2_np(meta):
    """Inverse of the meta2 word on numpy arrays, strands as +1/-1 int32."""
    return _unpack_meta2(
        meta, lambda bit: np.where(bit > 0, 1, -1).astype(np.int32))


def pair_predicate_packed2_np(qgap, r2_i, r1_j, meta, min_bp_match_cutoff,
                              min_mapq, gap_):
    """:func:`pair_predicate_np` over the resolved 4-column v2 layout, by
    the substitutions of :func:`pair_predicate_packed2`.  Returns
    (hit, iog); ``iog`` is not gated by MAPQ."""
    iog, si, mi, sj, mj = unpack_pair_meta2_np(meta)
    zero_i = np.zeros_like(qgap)
    zero_f = np.zeros(qgap.shape, np.float32)
    dummy = zero_i[:1]
    return pair_predicate_np(
        zero_i, qgap, zero_i, zero_i, r2_i, si, mi, zero_f,
        zero_i, r1_j, zero_i, sj, mj, zero_f,
        dummy, dummy, dummy,
        min_bp_match_cutoff, min_mapq, gap_, np.inf,
        first_overlap_fn=lambda *_: iog)


def pack_pairs3_host(pi, q_start, q_end, r1, r2, chrom, strand, mapq,
                     int_chrom, int_start, int_end, min_mapq: int = 20,
                     n_out: Optional[int] = None):
    """Host (numpy) emission of the v3 layout (:data:`PACKED3_COL_ORDER`)
    from flat ALIGNMENT columns for pairs (pi[p], pi[p]+1): the twin of
    the native ``bamcore.pack_pairs3``, bit-identical by test.  The MAPQ
    gate folds into the interval gate (``iogm``) and the same-strand
    reference jump ``grr`` is derived here, so the device only runs the
    decision chain."""
    pj = pi + 1
    iog = _alignment_gate(pi, chrom, r1, r2, int_chrom, int_start, int_end)
    mq = np.asarray(mapq)
    mq_ok = (mq[pi] >= min_mapq) & (mq[pj] >= min_mapq)
    iogm = np.where(mq_ok, iog, -1).astype(np.int32)
    st = np.asarray(strand)
    sj_pos = st[pj] > 0
    r2i = np.asarray(r2)[pi].astype(np.int32)
    r1j = np.asarray(r1)[pj].astype(np.int32)
    grr = np.where(sj_pos, r1j - r2i, r2i - r1j).astype(np.int32)
    qgap = (np.asarray(q_start)[pj] - np.asarray(q_end)[pi]).astype(np.int32)
    sdiff = (st[pi] != st[pj]).astype(np.int32)
    meta = ((iogm + 1) << META3_IOG_SHIFT) | sdiff
    return _zero_pad((qgap, grr, meta.astype(np.int32)), len(pi), n_out)


def pair_predicate_packed3_np(qgap, grr, meta, min_bp_match_cutoff, gap_):
    """:func:`pair_predicate_np` over the resolved 3-column v3 layout, by
    the substitutions of :func:`pair_predicate_packed3`.  Returns
    (hit, iogm)."""
    iogm, sdiff = unpack_pair_meta3(meta)
    zero_i = np.zeros_like(qgap)
    zero_f = np.zeros(qgap.shape, np.float32)
    one_i = np.ones_like(qgap)
    strand_i = np.where(sdiff > 0, -one_i, one_i)
    dummy = zero_i[:1]
    return pair_predicate_np(
        zero_i, qgap, zero_i, zero_i, zero_i, strand_i, 255, zero_f,
        zero_i, grr, zero_i, one_i, 255, zero_f,
        dummy, dummy, dummy,
        min_bp_match_cutoff, 0, gap_, np.inf,
        first_overlap_fn=lambda *_: iogm)


# --- tensor half: PyTorch --------------------------------------------------

def as_tensor(a, device: torch.device, dtype=None) -> torch.Tensor:
    """numpy array or tensor -> contiguous tensor on ``device`` (no copy
    when it already is one)."""
    t = a if isinstance(a, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


# at most this many (pair, interval) cells of the overlap mask at a time
_OVERLAP_CELLS = 1 << 25


def first_overlap(chrom, a, b, int_chrom, int_start, int_end):
    """Index of the first interval overlapping [a, b] on ``chrom``; -1 if
    none (``coral_tpu.ops.scoring.first_overlap``: the same storage-order
    test, which keeps the minus-strand r1 > r2 quirk).  int64 (n,)."""
    n = chrom.shape[0]
    n_int = int_chrom.shape[0]
    out = torch.full((n,), -1, dtype=torch.int64, device=chrom.device)
    if n_int == 0:
        return out
    lane = torch.arange(n_int, dtype=torch.int32, device=chrom.device)
    step = max(_OVERLAP_CELLS // n_int, 1)
    for lo in range(0, n, step):
        sl = slice(lo, lo + step)
        ov = (chrom[sl, None] == int_chrom[None, :]) \
            & (a[sl, None] <= int_end[None, :]) \
            & (int_start[None, :] <= b[sl, None])
        first = torch.where(ov, lane, n_int).amin(dim=1)
        out[sl] = torch.where(first < n_int, first, -1)
    return out


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
    """Inverse of the v3 meta word (numpy array or tensor):
    -> (iogm, strand_diff)."""
    return (meta >> META3_IOG_SHIFT) - 1, meta & 1


def unpack_pair_meta(meta):
    """Inverse of the 6-column meta word on a tensor: -> (chrom_i,
    strand_i, mapq_i, chrom_j, strand_j, mapq_j), strands as +1/-1."""
    return _unpack_sides(meta, lambda bit: bit * 2 - 1)


def pair_predicate_packed(qgap, r1_i, r2_i, r1_j, r2_j, meta,
                          int_chrom, int_start, int_end,
                          min_bp_match_cutoff, min_mapq, gap_):
    """:func:`pair_predicate` over the packed 6-column layout
    (``coral_tpu.ops.scoring.pair_predicate_packed``): the plain version of
    the 6-column kernels.  Returns (hit, io_i); ``io_i`` is the first
    interval of side i whatever side j does."""
    ci, si, mi, cj, sj, mj = unpack_pair_meta(meta)
    zero_i = torch.zeros_like(qgap)
    zero_f = torch.zeros(qgap.shape, dtype=torch.float32, device=qgap.device)
    return pair_predicate(
        zero_i, qgap, ci, r1_i, r2_i, si, mi, zero_f,
        cj, r1_j, r2_j, sj, mj, zero_f,
        int_chrom, int_start, int_end,
        min_bp_match_cutoff, min_mapq, gap_, math.inf)


def unpack_pair_meta2(meta):
    """Inverse of the meta2 word on a tensor: -> (iog, strand_i, mapq_i,
    strand_j, mapq_j), strands as +1/-1."""
    return _unpack_meta2(meta, lambda bit: bit * 2 - 1)


def pair_predicate_packed2(qgap, r2_i, r1_j, meta, min_bp_match_cutoff,
                           min_mapq, gap_):
    """:func:`pair_predicate` over the resolved 4-column v2 layout
    (``coral_tpu.ops.scoring.pair_predicate_packed2``): the plain version
    of the v2 kernels.  The gate resolved at pack time is injected as the
    interval search of both sides, and the chromosome, ``r1_i`` and
    ``r2_j`` slots, which the decision never reads once the search is
    resolved, are fed zeros.  Returns (hit, iog): unlike v3's ``iogm``,
    ``iog`` is not gated by MAPQ, and hits bin by it."""
    iog, si, mi, sj, mj = unpack_pair_meta2(meta)
    zero_i = torch.zeros_like(qgap)
    zero_f = torch.zeros(qgap.shape, dtype=torch.float32, device=qgap.device)
    dummy = zero_i[:1]
    return pair_predicate(
        zero_i, qgap, zero_i, zero_i, r2_i, si, mi, zero_f,
        zero_i, r1_j, zero_i, sj, mj, zero_f,
        dummy, dummy, dummy,
        min_bp_match_cutoff, min_mapq, gap_, math.inf,
        first_overlap_fn=lambda *_: iog)


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
    table and the packed pair columns, as tensors on one device.  The
    interval bounds are int64 for the v3 and v2 layouts (the device never
    reads them there, only the coverage query does) and int32 for the
    6-column layout, whose kernels scan them."""
    int_chrom: torch.Tensor   # int32 (n_int,)
    int_start: torch.Tensor   # int64 or int32 (n_int,)
    int_end: torch.Tensor
    packed: Tuple[torch.Tensor, ...]  # 3, 4 or 6 int32 (n,) columns


def state_from_numpy(int_chrom, int_start, int_end, packed, *,
                     device) -> ScoringState:
    """The JAX package's numpy interval table and packed columns, v3
    (``PACKED3_COL_ORDER``), v2 (``PACKED2_COL_ORDER``) or 6-column
    (``PACKED_COL_ORDER``) -> the port's tensors on ``device``."""
    if len(packed) not in (len(PACKED3_COL_ORDER), len(PACKED2_COL_ORDER),
                           len(PACKED_COL_ORDER)):
        raise ValueError(f"{len(packed)} packed columns: neither the v3, "
                         "the v2 nor the 6-column layout")
    dev = resolve_device(device)
    bounds = torch.int32 if len(packed) == len(PACKED_COL_ORDER) \
        else torch.int64
    return ScoringState(
        as_tensor(int_chrom, dev, torch.int32),
        as_tensor(int_start, dev, bounds),
        as_tensor(int_end, dev, bounds),
        tuple(as_tensor(c, dev, torch.int32) for c in packed))


# the predicate's scalars where a scorer is not given them
SCORING_DEFAULTS = dict(min_bp_match_cutoff=100, min_mapq=20, gap_=100.0,
                        max_nm=math.inf)


def make_batch_scorer(int_chrom, int_start, int_end, engine: str = "torch",
                      *, device, **scalars):
    """Product-shaped scorer (``coral_tpu.ops.scoring.make_batch_scorer_jax``):
    coverage tables build once per read batch, and each call scores one
    batch of pairs into per-interval support counts plus exact int64
    coverage per interval.

    ``engine='torch'``: ``score(tables, *14 COL_ORDER columns)`` with the
    plain predicate and ``torch.bincount``.  ``engine='cuda'``:
    ``score(tables, qgap, grr, meta)`` over the v3 layout with the fused
    predicate + histogram kernel (K2), at most ``MAX_PACKED2_INTERVALS``
    intervals.  ``engine='cuda2'`` (``engine='pallas2'`` there):
    ``score(tables, qgap, r2_i, r1_j, meta)`` over the v2 layout with its
    fused kernel (K6), which applies the MAPQ gate and derives the
    reference jump itself; the same limit.  ``engine='cuda6'``
    (``engine='pallas6'`` there):
    ``score(tables, qgap, r1_i, r2_i, r1_j, r2_j, meta)`` over the
    6-column layout with the kernel that finds each side's interval itself
    (K4), any number of intervals, by a scan of the table or, past
    ``kernels.PAIR6_SCAN_MAX_INTERVALS``, in the table's interval index,
    built once here; the kernel reads the low 32 bits of the bounds
    (``np.asarray(int_start, np.int32)`` there) and the coverage query
    reads all 64.  The CUDA engines have no NM gate.

    Returns (build_tables, score); ``score`` -> (support int32, cov int64).
    """
    dev = resolve_device(device)
    ic = as_tensor(int_chrom, dev, torch.int32)
    is_ = as_tensor(int_start, dev, torch.int64)
    ie = as_tensor(int_end, dev, torch.int64)
    n_int = int(ic.shape[0])
    params = {**SCORING_DEFAULTS, **scalars}

    def build_tables(starts, ends):
        return coverage_prefix_tables(as_tensor(starts, dev),
                                      as_tensor(ends, dev))

    def cov(tables):
        return coverage_prefix_eval(tables, ie) \
            - coverage_prefix_eval(tables, is_)

    if engine in ("cuda", "cuda2", "cuda6"):
        if not math.isinf(params["max_nm"]):
            raise ValueError(f"engine={engine!r} has no NM gate")
        cutoff, gap_ = params["min_bp_match_cutoff"], params["gap_"]
        min_mapq = int(math.ceil(params["min_mapq"]))
    if engine in ("cuda", "cuda2") and n_int > MAX_PACKED2_INTERVALS:
        raise ValueError(
            f"{n_int} intervals exceed the resolved layouts' "
            f"{MAX_PACKED2_INTERVALS}; use engine='cuda6'")
    if engine == "cuda":
        from .kernels import pair3_support

        def score(tables, qgap, grr, meta):
            support = pair3_support(
                *(as_tensor(c, dev, torch.int32) for c in (qgap, grr, meta)),
                n_int, cutoff, gap_)
            return support, cov(tables)

        return build_tables, score
    if engine == "cuda2":
        from .kernels import pair2_support

        def score(tables, *packed2):
            support = pair2_support(
                *(as_tensor(c, dev, torch.int32) for c in packed2),
                n_int, cutoff, min_mapq, gap_)
            return support, cov(tables)

        return build_tables, score
    if engine == "cuda6":
        from .interval_index import build_interval_index
        from .kernels import PAIR6_SCAN_MAX_INTERVALS, pair6_support

        table32 = ic, is_.to(torch.int32), ie.to(torch.int32)
        # built once for every batch, where the kernel looks sides up
        index = build_interval_index(*table32, dev) \
            if dev.type == "cuda" and n_int > PAIR6_SCAN_MAX_INTERVALS \
            else None

        def score(tables, *packed6):
            support = pair6_support(
                *table32, *(as_tensor(c, dev, torch.int32) for c in packed6),
                cutoff, min_mapq, gap_, index=index)
            return support, cov(tables)

        return build_tables, score
    if engine != "torch":
        raise ValueError(f"unknown engine {engine!r} (torch, cuda, cuda2 or "
                         "cuda6)")

    def score(tables, *cols):
        hit, io = pair_predicate(*(as_tensor(c, dev) for c in cols),
                                 ic, is_, ie, **params)
        support = torch.bincount(io[hit], minlength=n_int)[:n_int]
        return support.to(torch.int32), cov(tables)

    return build_tables, score


def make_fused_step(int_chrom, int_start, int_end, engine: str = "torch",
                    *, device, **scalars):
    """The fused scoring step (``coral_tpu.ops.scoring.make_fused_step_jax``,
    the step ``fused_scoring_step`` runs): the 14-column junction predicate
    with the NM gate, the per-interval support histogram and the
    per-interval aligned-base coverage, with the interval table closed
    over.

    Returns ``step(starts, ends, *cols)`` over the read spans and the 14
    columns of :data:`COL_ORDER` (numpy arrays or tensors) ->
    ``(support int32 (n_int,), coverage int64 (n_int,))``, tensors on
    ``device``.  Coverage is exact int64 from :func:`coverage_prefix_tables`
    built in each call, as the JAX step builds its tables.

    ``engine='torch'``: :func:`pair_predicate` and a bincount.
    ``engine='cuda'``: the columns packed into the 6-column layout on the
    device (:func:`pack_pair_cols`) and K4 (``kernels.pair6_support``),
    its interval index built once here above
    ``kernels.PAIR6_SCAN_MAX_INTERVALS`` intervals; the layout has no NM
    slot, so a finite ``max_nm`` raises, as the JAX package's Pallas
    scorers require ``max_nm=inf``."""
    params = {**SCORING_DEFAULTS, **scalars}
    if engine == "cuda":
        if not math.isinf(params["max_nm"]):
            raise ValueError(
                "engine='cuda' (K4 over the 6-column layout) has no NM gate: "
                f"max_nm={params['max_nm']!r} needs engine='torch'")
        scorer = "cuda6"
    elif engine == "torch":
        scorer = "torch"
    else:
        raise ValueError(f"unknown engine {engine!r} (torch or cuda)")
    dev = resolve_device(device)
    build_tables, score = make_batch_scorer(int_chrom, int_start, int_end,
                                            scorer, device=dev, **params)
    nm_cols = (COL_ORDER.index("nm_i"), COL_ORDER.index("nm_j"))

    def step(starts, ends, *cols):
        if len(cols) != len(COL_ORDER):
            raise ValueError(f"{len(cols)} pair columns, not the "
                             f"{len(COL_ORDER)} of COL_ORDER")
        cols = [as_tensor(c, dev) for c in cols]
        if engine == "cuda":
            cols = pack_pair_cols(*(c for k, c in enumerate(cols)
                                    if k not in nm_cols))
        return score(build_tables(starts, ends), *cols)

    return step


def make_fused_step_numpy(int_chrom, int_start, int_end, **scalars):
    """Host twin of :func:`make_fused_step`
    (``coral_tpu.ops.scoring.make_fused_step_numpy``):
    :func:`pair_predicate_np` and ``np.bincount``, with exact int64
    coverage from :func:`coverage_prefix_tables` on the CPU.  Returns
    ``step(starts, ends, *cols)`` -> (support int32, coverage int64)
    numpy arrays."""
    params = {**SCORING_DEFAULTS, **scalars}
    ic, is_, ie = (np.asarray(a) for a in (int_chrom, int_start, int_end))
    n_int = len(ic)
    bounds = (torch.from_numpy(ie.astype(np.int64)),
              torch.from_numpy(is_.astype(np.int64)))

    def step(starts, ends, *cols):
        hit, io = pair_predicate_np(*(np.asarray(c) for c in cols),
                                    ic, is_, ie, **params)
        support = np.bincount(io[hit], minlength=n_int)[:n_int]
        tables = coverage_prefix_tables(
            *(torch.from_numpy(np.asarray(a)) for a in (starts, ends)))
        cov = coverage_prefix_eval(tables, bounds[0]) \
            - coverage_prefix_eval(tables, bounds[1])
        return support.astype(np.int32), cov.numpy()

    return step
