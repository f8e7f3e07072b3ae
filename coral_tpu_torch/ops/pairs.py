"""Whole-table breakpoint-pair scoring: the port of ``coral_tpu/ops/pairs.py``.

The flat chimera table, the adjacent-pair scorer :func:`score_pairs_l`,
the whole-table extractor :func:`find_breakpoints_device` and the
two-interval batch extractor :func:`subset_to_bps_batch`, with their
BpTable emission.  Rows and tables are identical to the JAX package's for
every engine (tested).

Engines of :func:`score_pairs_l`:

* ``numpy``: the host engine, :func:`.scoring.pair_predicate_np`;
* ``torch``: the 14-column predicate on tensors
  (:func:`.scoring.pair_predicate`), the counterpart of the XLA
  ``_pair_predicates``.  It is the only engine with the NM gate;
* ``cuda``: the hand-written kernels.  Up to ``MAX_PACKED2_INTERVALS``
  intervals, K1 (:func:`.kernels.pair3_hitmask`) over the v3 columns,
  whose interval gate is resolved at pack time; above that, K3
  (:func:`.kernels.pair6_hitmask`) over the 6-column layout, which looks
  each side up in the interval table's index
  (:mod:`.interval_index`, built in the call).  Needs a CUDA device and
  the NM gate off (a finite ``max_nm`` goes to ``torch``).

``auto`` resolves by :func:`resolve_engine_ex`: a pair-count floor or a
caller's threshold, the device type, then on a card the cost model of
:mod:`.routing`, which ``cuda`` calls feed with what they took.
"""
from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..constants import CHR_IDX
from ..device import resolve_device
from ..tracing import span
from . import routing
from .routing import MIN_DEVICE_PAIRS
from .scoring import MAX_PACKED2_INTERVALS

logger = logging.getLogger(__name__)


@dataclass
class ChimeraTable:
    """Flat structure-of-arrays view of all chimeric alignments.

    Alignments of read k occupy rows [read_off[k], read_off[k+1]); within a
    read they are sorted by query start (the Chimera invariant).
    ``r1``/``r2`` hold the reference interval in storage order (r1 > r2 on
    the '-' strand, as in the per-read representation).
    """
    read_names: List[str]
    read_off: np.ndarray    # int32 [n_reads + 1]
    q_start: np.ndarray     # int64 [n_aln]
    q_end: np.ndarray
    chrom: np.ndarray       # int32 chromosome code (CHR_IDX; -1 unknown)
    r1: np.ndarray          # int64
    r2: np.ndarray
    strand: np.ndarray      # int8: +1 / -1
    mapq: np.ndarray        # int32
    nm: np.ndarray          # float32 per-base NM

    @property
    def n_alignments(self) -> int:
        return len(self.q_start)


def build_chimera_table(chimeras: Dict[str, object]) -> ChimeraTable:
    from .chimera import ChimeraStore

    if isinstance(chimeras, ChimeraStore):
        # zero-copy fast path over the native flat columns: only the BAM
        # ref-id -> canonical chromosome-code remap is computed
        qs, qe, ref, r1, r2, strand, mapq, nm = chimeras.cols
        lut = np.full(max(len(chimeras._ref_names), 1) + 1, -1, np.int32)
        for i, name in enumerate(chimeras._ref_names):
            lut[i] = CHR_IDX.get(name, -1)
        chrom = lut[ref]               # ref -1 -> lut[-1] == -1
        return ChimeraTable(
            chimeras.names, chimeras.chim_off.astype(np.int32),
            qs, qe, chrom, r1, r2,
            strand, mapq, nm.astype(np.float32))
    names = list(chimeras.keys())
    off = [0]
    cols: List[list] = [[] for _ in range(8)]
    for rn in names:
        chim = chimeras[rn]
        for i in range(len(chim.r)):
            r = chim.r[i]
            cols[0].append(chim.q[i][0])
            cols[1].append(chim.q[i][1])
            cols[2].append(CHR_IDX.get(r[0], -1))
            cols[3].append(r[1])
            cols[4].append(r[2])
            cols[5].append(1 if r[3] == "+" else -1)
            cols[6].append(chim.mapq[i])
            cols[7].append(chim.nm[i])
        off.append(off[-1] + len(chim.r))
    return ChimeraTable(
        names,
        np.asarray(off, np.int32),
        np.asarray(cols[0], np.int64), np.asarray(cols[1], np.int64),
        np.asarray(cols[2], np.int32),
        np.asarray(cols[3], np.int64), np.asarray(cols[4], np.int64),
        np.asarray(cols[5], np.int8), np.asarray(cols[6], np.int32),
        np.asarray(cols[7], np.float32),
    )


def adjacent_pair_indices(read_off: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(i, j=i+1) alignment-row pairs within each read."""
    n = read_off[-1]
    i = np.arange(n - 1) if n > 1 else np.zeros(0, np.int64)
    # drop pairs crossing read boundaries; a trailing EMPTY chimera
    # (malformed SA set kept as a zero-alignment entry) puts a boundary
    # offset == n, which must not index the mask
    is_boundary = np.zeros(max(int(n), 1), bool)
    inner = np.asarray(read_off[1:-1])
    is_boundary[inner[inner < int(n)]] = True
    keep = ~is_boundary[i + 1] if n > 1 else np.zeros(0, bool)
    return i[keep], i[keep] + 1


@dataclass
class RouteRecord:
    """One engine-routing decision and its measured scoring time, appended
    by :func:`find_breakpoints_device`.  ``seq`` increases monotonically
    across the process: snapshot by sequence number, not list index (the
    bounded list trims its head)."""
    engine: str
    n_pairs: int
    seconds: float
    reason: str
    seq: int = 0


ROUTE_RECORDS: List[RouteRecord] = []
_route_seq = [0]


def last_route_seq() -> int:
    """Records with ``seq`` greater than this were appended after the call."""
    return _route_seq[0]


def route_records_since(seq: int) -> List[RouteRecord]:
    return [r for r in ROUTE_RECORDS if r.seq > seq]


def clear_route_records() -> None:
    ROUTE_RECORDS.clear()


def resolve_engine(engine: str, n_pairs: int, device: torch.device,
                   device_pair_threshold: Optional[int] = None) -> str:
    """Resolve an ``auto`` engine request to a concrete scoring engine
    (:func:`resolve_engine_ex` without the reason)."""
    return resolve_engine_ex(engine, n_pairs, device,
                             device_pair_threshold)[0]


def resolve_engine_ex(engine: str, n_pairs: int, device: torch.device,
                      device_pair_threshold: Optional[int] = None,
                      n_intervals: int = 16,
                      compile_cold_s: Optional[float] = None
                      ) -> Tuple[str, str]:
    """(engine, reason) for ``engine`` on ``device``.  ``auto`` resolves,
    in this order: ``numpy`` below :data:`MIN_DEVICE_PAIRS` pairs or, when
    ``device_pair_threshold`` is set, below it; ``numpy`` on a CPU device;
    ``cuda`` at or above a set threshold; else the cost model of
    :func:`.routing.decide`, which prices the library's build and load
    (``compile_cold_s`` for the build) against the host.  Every rule
    before the cost model decides without measuring anything, and none
    touches the card.  Any other engine is returned as forced."""
    if engine != "auto":
        return engine, "forced"
    if device_pair_threshold is None and n_pairs < MIN_DEVICE_PAIRS:
        return "numpy", f"n_pairs {n_pairs} < {MIN_DEVICE_PAIRS} floor"
    if device_pair_threshold is not None and \
            n_pairs < device_pair_threshold:
        return "numpy", (f"n_pairs {n_pairs} < threshold "
                         f"{device_pair_threshold}")
    if device.type == "cpu":
        return "numpy", "cpu device"
    if device_pair_threshold is not None:
        return "cuda", (f"n_pairs {n_pairs} >= threshold "
                        f"{device_pair_threshold}")
    return routing.decide(n_pairs, n_intervals, device, compile_cold_s)


def find_breakpoints_device(
    chimeras: Dict[str, object],
    intervals: List[list],
    min_bp_match_cutoff: int,
    min_mapq: float,
    gap_: float,
    gap_mapq: float = 10,
    max_nm: Optional[float] = None,
    engine: str = "auto",
    as_table: bool = False,
    *,
    device,
    mesh=None,
    mesh_axis: str = "dp",
    device_pair_threshold: Optional[int] = None,
    compile_cold_s: Optional[float] = None,
) -> List[list]:
    """Whole-table breakpoint extraction with the pair predicate evaluated
    by :func:`score_pairs_l` on ``device`` or, with ``mesh`` set, by
    :func:`coral_tpu_torch.parallel.sharded.score_pairs_sharded` over the
    mesh's ``mesh_axis`` (``coral_tpu.ops.pairs.find_breakpoints_device``).

    Produces exactly the same rows in exactly the same order as running
    ``chimera_to_bps_l`` per read, for any engine and shard count; the
    low-mapq rescue pass runs on the host for the few affected reads.
    ``as_table=True`` returns the same observations as a flat-column
    ``coral_tpu.ops.breakpoints.BpTable``.  Without a mesh, ``auto``
    resolves through :func:`resolve_engine_ex` (``device_pair_threshold``
    and ``compile_cold_s`` as there); the decision and its reason are
    logged and kept in the call's :class:`RouteRecord`.
    """
    from .breakpoints import interval_to_bp, \
        interval_overlap_l, rescue_pass

    dev = resolve_device(device)
    table = build_chimera_table(chimeras)
    n_pairs = max(table.n_alignments - len(table.read_names), 0)
    nm_resolved = np.inf if max_nm is None else max_nm
    if mesh is None:
        engine, reason = resolve_engine_ex(
            engine, n_pairs, dev, device_pair_threshold, len(intervals),
            compile_cold_s)
    else:
        from ..parallel.sharded import resolve_mesh_engine

        engine, reason = resolve_mesh_engine(engine, mesh)
        reason = f"mesh axis {mesh_axis} of {mesh.shape[mesh_axis]}; {reason}"
    logger.info("pair scoring route: engine=%s (%d pairs; %s)",
                engine, n_pairs, reason)
    with span("pair_scoring"):
        t0 = time.perf_counter()
        if mesh is None:
            pi, pj, hits = score_pairs_l(
                table, intervals, min_bp_match_cutoff, min_mapq, gap_,
                nm_resolved, engine=engine, device=dev)
        else:
            from ..parallel.sharded import score_pairs_sharded

            pi, pj, hits = score_pairs_sharded(
                table, intervals, min_bp_match_cutoff, min_mapq, gap_, mesh,
                mesh_axis, nm_resolved, engine=engine)
        dt = time.perf_counter() - t0
    logger.info("pair scoring route: engine=%s scored %d pairs in %.3fs",
                engine, n_pairs, dt)
    _route_seq[0] += 1
    ROUTE_RECORDS.append(RouteRecord(engine, n_pairs, dt, reason,
                                     _route_seq[0]))
    if len(ROUTE_RECORDS) > 4096:
        del ROUTE_RECORDS[:2048]
    # per-pair hit mask back into per-read slices
    hit_by_row = np.zeros(max(table.n_alignments, 1), bool)
    hit_by_row[pi] = hits
    off = np.asarray(table.read_off, np.int64)

    # ---- rescue-eligible reads (vectorized coarse test over the flat
    # columns; the exact per-read test + rescue itself stay on the slow
    # path, spliced back in read order below).  A middle alignment m is a
    # rescue candidate when neither adjacent pair was assigned, its mapq
    # is sub-gap_mapq and both neighbors pass min_mapq.
    n_aln = table.n_alignments
    is_first = np.zeros(max(n_aln, 1), bool)
    is_first[off[:-1][off[:-1] < n_aln]] = True
    is_last = np.zeros(max(n_aln, 1), bool)
    last_rows = off[1:] - 1
    is_last[last_rows[(last_rows >= 0) & (last_rows < n_aln)]] = True
    mapq = np.asarray(table.mapq)
    mid = np.zeros(max(n_aln, 1), bool)
    if n_aln >= 3:
        m = np.arange(1, n_aln - 1)
        mid[m] = (~is_first[m] & ~is_last[m]
                  & (mapq[m] < gap_mapq)
                  & (mapq[m - 1] >= min_mapq) & (mapq[m + 1] >= min_mapq)
                  & ~hit_by_row[m - 1] & ~hit_by_row[m])
    slow_reads = np.unique(
        np.searchsorted(off, np.flatnonzero(mid), side="right") - 1)

    # ---- vectorized emission for every assigned pair of a FAST read,
    # straight off the flat columns, with the exact interval_to_bp
    # canonicalization (coral_tpu/ops/breakpoints.py) inlined branch-free
    hit_rows = pi[hits]
    read_of_hit = np.searchsorted(off, hit_rows, side="right") - 1
    if len(slow_reads):
        fast_mask = ~np.isin(read_of_hit, slow_reads)
    else:
        fast_mask = np.ones(len(hit_rows), bool)
    if as_table:
        return _emit_bp_table(
            table, hit_rows[fast_mask], read_of_hit[fast_mask], off,
            hit_by_row, slow_reads, chimeras, intervals, min_mapq,
            gap_mapq, max_nm, gap_, min_bp_match_cutoff)
    hr = hit_rows[fast_mask]
    rd = read_of_hit[fast_mask]
    jr = hr + 1
    code_to_name = [None] * (len(CHR_IDX) + 1)
    for name, code in CHR_IDX.items():
        code_to_name[code] = name
    qgap_l = (np.asarray(table.q_start)[jr]
              - np.asarray(table.q_end)[hr]).tolist()
    ci_l = np.asarray(table.chrom)[hr].tolist()
    cj_l = np.asarray(table.chrom)[jr].tolist()
    p1_l = np.asarray(table.r2)[hr].tolist()     # 3' end of alignment i
    p2_l = np.asarray(table.r1)[jr].tolist()     # 5' start of alignment j
    si_l = np.asarray(table.strand)[hr].tolist()
    sj_l = np.asarray(table.strand)[jr].tolist()
    mqi_l = mapq[hr].tolist()
    mqj_l = mapq[jr].tolist()
    iloc_l = (hr - off[rd]).tolist()
    rd_l = rd.tolist()
    names = table.read_names
    fast_rows: List[list] = []
    for t in range(len(hr)):
        ci = ci_l[t]
        cj = cj_l[t]
        il = iloc_l[t]
        rn = names[rd_l[t]]
        si = "+" if si_l[t] > 0 else "-"
        sjf = "-" if sj_l[t] > 0 else "+"   # second side flipped
        if cj < ci or (cj == ci and p2_l[t] < p1_l[t]):
            row = [code_to_name[ci], p1_l[t], si,
                   code_to_name[cj], p2_l[t], sjf,
                   (rn, il, il + 1), qgap_l[t], 0,
                   mqi_l[t], mqj_l[t]]
        else:
            row = [code_to_name[cj], p2_l[t], sjf,
                   code_to_name[ci], p1_l[t], si,
                   (rn, il + 1, il), qgap_l[t], 1,
                   mqi_l[t], mqj_l[t]]
        fast_rows.append(row)

    if not len(slow_reads):
        return fast_rows

    # ---- slow path (rescue-eligible reads): the per-read reference
    # semantics, spliced into the fast rows in read order
    out: List[list] = []
    fast_pos = 0
    for k in slow_reads.tolist():
        while fast_pos < len(fast_rows) and rd_l[fast_pos] < k:
            out.append(fast_rows[fast_pos])
            fast_pos += 1
        rn = names[k]
        lo, hi = int(off[k]), int(off[k + 1])
        if hi - lo < 2:
            continue
        assigned = hit_by_row[lo: hi - 1]
        chim = chimeras[rn]
        q, r, mq, nm = chim.q, chim.r, chim.mapq, chim.nm
        for i in np.flatnonzero(assigned):
            i = int(i)
            qgap = int(q[i + 1][0]) - int(q[i][1])
            out.append(interval_to_bp(r[i], r[i + 1], (rn, i, i + 1), qgap)
                       + [mq[i], mq[i + 1]])

        def _same_list(a, b, r=r):
            io1 = interval_overlap_l(r[a], intervals)
            io2 = interval_overlap_l(r[b], intervals)
            return io1 >= 0 and io2 >= 0 and io1 == io2

        rescue_pass(
            rn, q, r, mq, nm, assigned, _same_list, out,
            min_mapq=min_mapq, gap_mapq=gap_mapq, max_nm=max_nm,
            gap_=gap_, min_bp_match_cutoff=min_bp_match_cutoff)
    out.extend(fast_rows[fast_pos:])
    return out


def _empty_bp_table(names):
    from .breakpoints import BpTable

    z64 = np.zeros(0, np.int64)
    return BpTable(np.zeros(0, np.int32), z64, np.zeros(0, bool),
                   np.zeros(0, np.int32), z64, np.zeros(0, bool),
                   z64, z64, z64, z64, np.zeros(0, np.int8), z64, z64,
                   names)


def _canon_pair_cols(chrom, r1, r2, strand, q_start, q_end, mapq, t, iloc):
    """Vectorized interval_to_bp canonicalization
    (coral_tpu/ops/breakpoints.py) for the pairs (t, t+1).  ``iloc`` is the
    within-read index of alignment ``t``.  Returns the 12 fast-column
    arrays of a BpTable (everything but ridx/names)."""
    j = t + 1
    ci = chrom[t].astype(np.int64)
    cj = chrom[j].astype(np.int64)
    p1 = r2[t]
    p2 = r1[j]
    si = strand[t] > 0
    sj = strand[j] > 0
    # flag-1 ("swapped") is interval_to_bp's ELSE branch: NOT
    # (chr_j < chr_i or (equal and p2 < p1))
    swap = (ci < cj) | ((ci == cj) & (p2 >= p1))
    return (np.where(swap, cj, ci).astype(np.int32),       # c1
            np.where(swap, p2, p1),                        # p1
            np.where(swap, ~sj, si),                       # s1
            np.where(swap, ci, cj).astype(np.int32),       # c2
            np.where(swap, p1, p2),                        # p2
            np.where(swap, si, ~sj),                       # s2
            np.where(swap, iloc + 1, iloc),                # ti
            np.where(swap, iloc, iloc + 1),                # tj
            q_start[j] - q_end[t],                         # rgap
            swap.astype(np.int8),                          # flip
            mapq[t],                                       # q1
            mapq[j])                                       # q2


def _merge_bp_table(fast_cols, ridx, fast_key, slow_pairs, names):
    """Stable-merge the fast columns with per-row slow rows by key
    (read/span index; fast and slow keys are disjoint, so the merge
    reproduces the row path's splice order exactly).  ``slow_pairs`` is
    [(key, row)] in key order; their ``r`` tuples land in ``tup``."""
    from .breakpoints import BpTable

    (f_c1, f_p1, f_s1, f_c2, f_p2, f_s2, f_ti, f_tj, f_rgap, f_flip,
     f_q1, f_q2) = fast_cols
    if not slow_pairs:
        return BpTable(f_c1, f_p1, f_s1, f_c2, f_p2, f_s2,
                       ridx.astype(np.int64), f_ti, f_tj, f_rgap, f_flip,
                       f_q1, f_q2, names)
    n_s = len(slow_pairs)
    s_k = np.fromiter((k for k, _ in slow_pairs), np.int64, n_s)
    zero = np.zeros(n_s, np.int64)
    order = np.argsort(np.concatenate([fast_key, s_k]), kind="stable")
    pos_of = np.argsort(order, kind="stable")
    n_f = len(f_p1)

    def col(fast, fn, dtype):
        return np.concatenate([
            fast, np.fromiter((fn(r) for _, r in slow_pairs),
                              dtype, n_s)])[order]

    return BpTable(
        col(f_c1, lambda r: CHR_IDX[r[0]], np.int32),
        col(f_p1, lambda r: r[1], np.int64),
        col(f_s1, lambda r: r[2] == "+", bool),
        col(f_c2, lambda r: CHR_IDX[r[3]], np.int32),
        col(f_p2, lambda r: r[4], np.int64),
        col(f_s2, lambda r: r[5] == "+", bool),
        np.concatenate([ridx.astype(np.int64),
                        np.full(n_s, -1, np.int64)])[order],
        np.concatenate([f_ti, zero])[order],
        np.concatenate([f_tj, zero])[order],
        col(f_rgap, lambda r: r[7], np.int64),
        col(f_flip, lambda r: r[8], np.int8),
        col(f_q1, lambda r: r[9], np.int64),
        col(f_q2, lambda r: r[10], np.int64),
        names,
        {int(pos_of[n_f + t]): slow_pairs[t][1][6] for t in range(n_s)})


def _emit_bp_table(table, hr, rd, off, hit_by_row, slow_reads, chimeras,
                   intervals, min_mapq, gap_mapq, max_nm, gap_,
                   min_bp_match_cutoff):
    """Flat-column emission for :func:`find_breakpoints_device`
    (``as_table=True``): the canonicalization vectorized over the hit
    pairs; rescue-read rows (built by the exact per-read path) spliced in
    read order, exactly where the row path puts them."""
    from .breakpoints import interval_to_bp, \
        interval_overlap_l, rescue_pass

    names = table.read_names
    fast_cols = _canon_pair_cols(
        np.asarray(table.chrom), np.asarray(table.r1, np.int64),
        np.asarray(table.r2, np.int64), np.asarray(table.strand),
        np.asarray(table.q_start, np.int64),
        np.asarray(table.q_end, np.int64),
        np.asarray(table.mapq, np.int64), hr, hr - off[rd])
    slow_pairs = []
    for k in slow_reads.tolist():
        rn = names[k]
        lo, hi = int(off[k]), int(off[k + 1])
        if hi - lo < 2:
            continue
        assigned = hit_by_row[lo: hi - 1]
        chim = chimeras[rn]
        q, r, mq, nm = chim.q, chim.r, chim.mapq, chim.nm
        rows_k: List[list] = []
        for i in np.flatnonzero(assigned):
            i = int(i)
            qgap = int(q[i + 1][0]) - int(q[i][1])
            rows_k.append(
                interval_to_bp(r[i], r[i + 1], (rn, i, i + 1), qgap)
                + [mq[i], mq[i + 1]])

        def _same_list(a, b, r=r):
            io1 = interval_overlap_l(r[a], intervals)
            io2 = interval_overlap_l(r[b], intervals)
            return io1 >= 0 and io2 >= 0 and io1 == io2

        rescue_pass(
            rn, q, r, mq, nm, assigned, _same_list, rows_k,
            min_mapq=min_mapq, gap_mapq=gap_mapq, max_nm=max_nm,
            gap_=gap_, min_bp_match_cutoff=min_bp_match_cutoff)
        slow_pairs.extend((k, row) for row in rows_k)
    return _merge_bp_table(fast_cols, rd, rd, slow_pairs, names)


def score_pairs_two_intervals(
    table: ChimeraTable,
    rows: np.ndarray,
    intrvl1: list,
    intrvl2: list,
    min_bp_match_cutoff: int,
    min_mapq: float,
    max_nm: float = np.inf,
) -> np.ndarray:
    """Two-interval adjacent-pair predicate (``alignment2bp`` semantics,
    reference ``breakpoint_utilities.py:70-126``) evaluated for the pairs
    (rows[k], rows[k]+1): one side in each interval, either order; no
    same-strand requirement."""
    i = rows
    j = rows + 1

    def overlaps(idx, iv):
        code = CHR_IDX.get(iv[0], -2)
        return (table.chrom[idx] == code) & (table.r1[idx] <= iv[2]) \
            & (iv[1] <= table.r2[idx])

    qgap = table.q_start[j] - table.q_end[i]
    pair_in = (overlaps(i, intrvl1) & overlaps(j, intrvl2)) \
        | (overlaps(j, intrvl1) & overlaps(i, intrvl2))
    hit = (qgap + min_bp_match_cutoff >= 0) & pair_in \
        & (table.mapq[i] >= min_mapq) & (table.mapq[j] >= min_mapq)
    if not np.isinf(max_nm):
        # gate ON only for finite cutoffs: degenerate 1-base alignments
        # carry inf/NaN per-base NM, and inf<inf / NaN<x would reject
        # rows the gate-off host semantics (max_nm is None -> pass) keep
        hit = hit & (table.nm[i] < max_nm) & (table.nm[j] < max_nm)
    return hit


def subset_to_bps_batch(
    store,
    read_names,
    intrvl1: list,
    intrvl2: list,
    min_bp_match_cutoff: int,
    min_mapq: float,
    gap_mapq: float = 10,
    max_nm: Optional[float] = None,
    as_table: bool = False,
    slots: Optional[np.ndarray] = None,
) -> List[list]:
    """Batched two-interval breakpoint extraction for a subset of reads of
    a native ChimeraStore (``coral_tpu.ops.pairs.subset_to_bps_batch``);
    row-identical (including order and the low-mapq rescue pass) to
    calling ``chimera_to_bps`` per read.  ``as_table=True`` returns a
    flat-column BpTable; ``slots`` (store slot per read) skips the
    name -> slot mapping."""
    from .breakpoints import interval_overlap, \
        interval_to_bp, rescue_pass

    read_names = list(read_names)
    if not read_names:
        return _empty_bp_table(read_names) if as_table else []
    if slots is not None:
        slots = np.asarray(slots, np.int64)
    else:
        slot = store._slot
        slots = np.fromiter((slot[rn] for rn in read_names), np.int64,
                            len(read_names))
    off = np.asarray(store.chim_off, np.int64)
    lo_a = off[slots]
    hi_a = off[slots + 1]
    pair_cnt = np.maximum(hi_a - lo_a - 1, 0)
    tot = int(pair_cnt.sum())
    if tot == 0:
        return _empty_bp_table(read_names) if as_table else []
    full = store.flat_table()
    # ragged arange of pair rows [lo, hi-1) per span, span-major order
    shift = np.cumsum(pair_cnt) - pair_cnt
    rows = (np.arange(tot, dtype=np.int64)
            - np.repeat(shift, pair_cnt) + np.repeat(lo_a, pair_cnt))
    hits = score_pairs_two_intervals(
        full, rows, intrvl1, intrvl2, min_bp_match_cutoff, min_mapq,
        np.inf if max_nm is None else max_nm)
    # per-span aggregates, vectorized:
    #   has_hit: any adjacent pair of the span passed the predicate
    #   rescue:  n >= 3 and any INTERIOR alignment mapq < gap_mapq
    nspan = len(slots)
    pair_span = np.repeat(np.arange(nspan, dtype=np.int64), pair_cnt)
    has_hit = np.zeros(nspan, bool)
    has_hit[pair_span[hits]] = True
    mq_c = full.mapq
    lowmq_ps = np.zeros(len(mq_c) + 1, np.int64)
    np.cumsum(mq_c < gap_mapq, out=lowmq_ps[1:])
    n_a = hi_a - lo_a
    interior_lo = np.minimum(lo_a + 1, len(mq_c))
    rescue_mask = (n_a >= 3) & (
        lowmq_ps[np.maximum(hi_a - 1, interior_lo)]
        - lowmq_ps[interior_lo] > 0)
    emit = np.flatnonzero(has_hit | rescue_mask)
    if len(emit) == 0:
        return _empty_bp_table(read_names) if as_table else []

    def _rescue_rows(rn, assigned, chim, rows_k):
        q, r, mq, nm = chim.q, chim.r, chim.mapq, chim.nm
        for i in np.flatnonzero(assigned):
            i = int(i)
            qgap = int(q[i + 1][0]) - int(q[i][1])
            rows_k.append(
                interval_to_bp(r[i], r[i + 1], (rn, i, i + 1), qgap)
                + [mq[i], mq[i + 1]])
        rescue_pass(
            rn, q, r, mq, nm, assigned,
            lambda a, b, r=r: (
                (interval_overlap(r[a], intrvl1)
                 and interval_overlap(r[b], intrvl2))
                or (interval_overlap(r[b], intrvl1)
                    and interval_overlap(r[a], intrvl2))),
            rows_k, min_mapq=min_mapq, gap_mapq=gap_mapq, max_nm=max_nm)

    if as_table:
        # fast hits canonicalized vectorized, rescue-span rows spliced by
        # span order (the splice the row path does)
        fast_sel = hits & ~rescue_mask[pair_span]
        fi = np.flatnonzero(fast_sel)
        t_f = rows[fi]
        fast_cols = _canon_pair_cols(
            full.chrom, np.asarray(full.r1, np.int64),
            np.asarray(full.r2, np.int64), full.strand,
            np.asarray(full.q_start, np.int64),
            np.asarray(full.q_end, np.int64),
            np.asarray(mq_c, np.int64), t_f, fi - shift[pair_span[fi]])
        slow_pairs = []
        for s in np.flatnonzero(rescue_mask).tolist():
            rn = read_names[s]
            p0 = int(shift[s])
            rows_k: List[list] = []
            _rescue_rows(rn, hits[p0: p0 + int(pair_cnt[s])],
                         store.chimera_at(int(slots[s]), rn), rows_k)
            slow_pairs.extend((s, row) for row in rows_k)
        ridx = pair_span[fi]
        return _merge_bp_table(fast_cols, ridx, ridx, slow_pairs,
                               read_names)
    # bulk-extract the hit-pair columns once; hit positions are span-major
    # ascending = the scalar loop's emission order
    hit_idx = np.flatnonzero(hits)
    hs = pair_span[hit_idx]
    t_arr = rows[hit_idx]
    ref_names = store._ref_names
    refcol = store.cols[2]
    qgap_l = (full.q_start[t_arr + 1] - full.q_end[t_arr]).tolist()
    ilocal_l = (hit_idx - shift[hs]).tolist()
    ri_c = refcol[t_arr].tolist()
    rj_c = refcol[t_arr + 1].tolist()
    ri_1 = full.r1[t_arr].tolist()
    ri_2 = full.r2[t_arr].tolist()
    rj_1 = full.r1[t_arr + 1].tolist()
    rj_2 = full.r2[t_arr + 1].tolist()
    si_l = full.strand[t_arr].tolist()
    sj_l = full.strand[t_arr + 1].tolist()
    mi_l = mq_c[t_arr].tolist()
    mj_l = mq_c[t_arr + 1].tolist()
    g_lo = np.searchsorted(hs, emit, side="left").tolist()
    g_hi = np.searchsorted(hs, emit, side="right").tolist()
    rescue_l = rescue_mask[emit].tolist()
    pstart_l = shift[emit].tolist()
    pcnt_l = pair_cnt[emit].tolist()
    out: List[list] = []
    for e, s in enumerate(emit.tolist()):
        rn = read_names[s]
        if not rescue_l[e]:
            for p in range(g_lo[e], g_hi[e]):
                i = ilocal_l[p]
                r_i = [ref_names[ri_c[p]] if ri_c[p] >= 0 else "?",
                       ri_1[p], ri_2[p], "+" if si_l[p] > 0 else "-"]
                r_j = [ref_names[rj_c[p]] if rj_c[p] >= 0 else "?",
                       rj_1[p], rj_2[p], "+" if sj_l[p] > 0 else "-"]
                out.append(
                    interval_to_bp(r_i, r_j, (rn, i, i + 1), qgap_l[p])
                    + [mi_l[p], mj_l[p]])
            continue
        # rescue-eligible read (rare: interior mapq < gap_mapq)
        p0 = pstart_l[e]
        _rescue_rows(rn, hits[p0: p0 + pcnt_l[e]], store[rn], out)
    return out


def score_pairs_l(
    table: ChimeraTable,
    intervals: List[list],
    min_bp_match_cutoff: int,
    min_mapq: float,
    gap_: float,
    max_nm: float = np.inf,
    batch: int = 1 << 18,
    engine: str = "numpy",
    *,
    device,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Evaluate the adjacent-pair predicate over the whole table.  Returns
    (pair_i, pair_j, hit_mask) in table row coordinates (numpy)."""
    pi, pj = adjacent_pair_indices(table.read_off)
    if pi.size == 0:
        return pi, pj, np.zeros(0, bool)
    # a call that finds the library loaded pays no build or load: its
    # time is what the cost model predicts for a warm call
    warm = engine == "cuda" and np.isinf(max_nm) \
        and routing.library_state() == "loaded"
    t0 = time.perf_counter()
    score = make_pair_scorer(table, intervals, min_bp_match_cutoff, min_mapq,
                             gap_, max_nm, engine, device=device, batch=batch)
    hits = score(pi)
    if warm:
        routing.observe(routing.route_of(len(intervals)),
                        resolve_device(device), time.perf_counter() - t0,
                        pi.size)
    return pi, pj, hits


def make_pair_scorer(table: ChimeraTable, intervals: List[list],
                     min_bp_match_cutoff: int, min_mapq: float, gap_: float,
                     max_nm: float = np.inf, engine: str = "numpy", *,
                     device, batch: int = 1 << 18):
    """The predicate of :func:`score_pairs_l` as a function of the pair
    rows: ``score(pi)`` -> the hit mask of the pairs ``(pi, pi + 1)``,
    bool numpy.  What a call would redo for every block of pairs is done
    here once: the interval table on ``device`` and, on the 6-column
    route of the ``cuda`` engine, its interval index."""
    dev = resolve_device(device)
    int_chrom = np.asarray([CHR_IDX.get(iv[0], -2) for iv in intervals],
                           np.int32)
    int_start = np.asarray([iv[1] for iv in intervals], np.int64)
    int_end = np.asarray([iv[2] for iv in intervals], np.int64)
    if engine == "cuda" and not np.isinf(max_nm):
        # K1 carries no NM columns; dropping the edit-distance gate would
        # admit breakpoints the reference's filter_bp_by_edit_distance
        # path rejects
        logger.warning("engine='cuda' does not implement the NM gate "
                       "(max_nm=%s); using the torch engine", max_nm)
        engine = "torch"
    if engine == "cuda":
        return _cuda_scorer(table, int_chrom, int_start, int_end,
                            min_bp_match_cutoff, min_mapq, gap_, dev)
    if engine not in ("numpy", "torch"):
        raise ValueError(f"unknown engine {engine!r} (numpy, torch, cuda)")
    nm_col = table.nm
    if np.isinf(max_nm):
        # gate-off contract owned HERE (not per caller): zero nm + inf
        # cutoff, so inf/NaN per-base NM of degenerate alignments cannot
        # reject pairs, and every engine agrees with K1 (no NM columns)
        nm_col = np.zeros_like(table.nm)
    if engine == "torch":
        from .scoring import as_tensor
        from .scoring import pair_predicate as predicate

        ints = [as_tensor(a, dev) for a in (int_chrom, int_start, int_end)]

        def fn(*cols14):
            hit, _ = predicate(*(as_tensor(c, dev) for c in cols14), *ints,
                               min_bp_match_cutoff, min_mapq, float(gap_),
                               float(max_nm))
            return hit.cpu().numpy()
    else:
        from .scoring import pair_predicate_np as predicate

        def fn(*cols14):
            return predicate(*cols14, int_chrom, int_start, int_end,
                             min_bp_match_cutoff, min_mapq, float(gap_),
                             float(max_nm))[0]

    def score(pi: np.ndarray) -> np.ndarray:
        hits = np.zeros(pi.size, bool)
        for lo in range(0, pi.size, batch):
            sl = slice(lo, min(lo + batch, pi.size))
            i = pi[sl]
            j = i + 1
            hits[sl] = fn(
                table.q_end[i], table.q_start[j],
                table.chrom[i], table.r1[i], table.r2[i],
                table.strand[i].astype(np.int32), table.mapq[i], nm_col[i],
                table.chrom[j], table.r1[j], table.r2[j],
                table.strand[j].astype(np.int32), table.mapq[j], nm_col[j])
        return hits
    return score


def _cuda_scorer(table, int_chrom, int_start, int_end, min_bp_match_cutoff,
                 min_mapq, gap_, dev):
    """The hit mask from K1 (v3 columns) or, above
    ``MAX_PACKED2_INTERVALS`` intervals, K3 (6 columns, the interval
    table's index built here, once)."""
    _require_cuda(dev)
    args = (int_chrom, int_start, int_end, min_bp_match_cutoff,
            int(math.ceil(min_mapq)), float(gap_), dev)
    if len(int_chrom) <= MAX_PACKED2_INTERVALS:
        return lambda pi: _hitmask_v3(table, pi, *args)
    from .interval_index import build_interval_index

    index = build_interval_index(int_chrom, int_start, int_end, dev)
    return lambda pi: _hitmask_6col(table, pi, *args, index=index)


def _require_cuda(dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"engine='cuda' needs a CUDA device, got {dev}")


def _hitmask_v3(table, pi, int_chrom, int_start, int_end, cutoff, min_mapq,
                gap_, dev):
    """v3 columns (interval and MAPQ gates resolved at pack time) from the
    native one-pass packer, numpy twin when the library is unavailable,
    through :func:`.kernels.pair3_hitmask`."""
    from .kernels import pair3_hitmask
    from .scoring import as_tensor, pack_pairs3_host

    args = (pi, table.q_start, table.q_end, table.r1, table.r2,
            table.chrom, table.strand, table.mapq,
            int_chrom, int_start, int_end)
    try:
        from ..native.bamcore import pack_pairs3

        packed3 = pack_pairs3(*args, min_mapq=min_mapq, n_out=pi.size)
    except OSError:
        packed3 = pack_pairs3_host(*args, min_mapq=min_mapq, n_out=pi.size)
    cols = [as_tensor(c, dev, torch.int32) for c in packed3]
    return pair3_hitmask(*cols, cutoff, gap_).cpu().numpy()


def _hitmask_6col(table, pi, int_chrom, int_start, int_end, cutoff, min_mapq,
                  gap_, dev, index=None):
    """6 columns from the native one-pass packer (numpy twin when the
    library is unavailable) through :func:`.kernels.pair6_hitmask`, which
    finds each side's interval itself, in the table's interval index
    (``index``, or built in the call): the gate index of a long list no
    longer fits the v3 meta word.  The bounds are int32 there, as in the
    JAX package."""
    from .kernels import pair6_hitmask
    from .scoring import as_tensor, pack_pair_cols

    try:
        from ..native.bamcore import pack_pairs

        packed = pack_pairs(pi, table.q_start, table.q_end, table.r1,
                            table.r2, table.chrom, table.strand, table.mapq,
                            n_out=pi.size)
    except OSError:
        pj = pi + 1
        packed = pack_pair_cols(
            table.q_end[pi], table.q_start[pj], table.chrom[pi],
            table.r1[pi], table.r2[pi], table.strand[pi].astype(np.int32),
            table.mapq[pi], table.chrom[pj], table.r1[pj], table.r2[pj],
            table.strand[pj].astype(np.int32), table.mapq[pj])
    ints = [as_tensor(a, dev, torch.int32)
            for a in (int_chrom, int_start, int_end)]
    cols = [as_tensor(c, dev, torch.int32) for c in packed]
    hit, _ = pair6_hitmask(*ints, *cols, cutoff, min_mapq, gap_, index=index)
    return hit.cpu().numpy()
