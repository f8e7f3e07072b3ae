"""Breakpoint extraction, clustering, and consensus calling.

Behavioral reimplementation of the reference's interval/breakpoint
utilities (``src/breakpoint_utilities.py``).  A breakpoint row is the same
11-field list layout the reference uses throughout:

    [chr1, pos1, o1, chr2, pos2, o2, r, rgap, flip, q1, q2]

where ``r`` is ``(read_name, i, j)`` naming the pair of local alignments
that produced it, ``rgap`` the read-side gap, and ``flip`` records whether
canonicalization swapped the two sides (``interval2bp``,
``breakpoint_utilities.py:289-295``).

The pair-predicate evaluation is also available as a vectorized batch
engine (``ops/pairs.py``) for the whole-table device path; this module is
the exact per-read semantics both must agree on.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..constants import CHR_IDX, FLIP_STRAND


# -- interval predicates (reference :11-67) --------------------------------

def interval_overlap(a, b) -> bool:
    """[chr, s, e] closed-interval overlap."""
    return a[0] == b[0] and int(a[1]) <= int(b[2]) and int(b[1]) <= int(a[2])


def interval_include(a, b) -> bool:
    return a[0] == b[0] and int(a[1]) >= int(b[1]) and int(a[2]) <= int(b[2])


def interval_adjacent(a, b) -> bool:
    if a[0] != b[0]:
        return False
    if a[1] <= b[1]:
        return b[1] == a[2] + 1
    return a[1] == b[2] + 1


def interval_overlap_l(a, intervals) -> int:
    """Index of the first interval overlapping a, else -1."""
    for i, b in enumerate(intervals):
        if interval_overlap(a, b):
            return i
    return -1


def interval_include_l(a, intervals) -> int:
    for i, b in enumerate(intervals):
        if interval_include(a, b):
            return i
    return -1


def interval_exclusive(a, intervals):
    """Subtract every interval in ``intervals`` from ``a``.

    Returns (set of overlapped interval indices, remaining uncovered pieces
    as [chr, s, e, -1]) — reference ``:54-67``.
    """
    overlap_ids = set()
    pieces = [[x for x in a]]
    for i, b in enumerate(intervals):
        for pi in range(len(pieces) - 1, -1, -1):
            p = pieces[pi]
            if interval_overlap(p, b):
                overlap_ids.add(i)
                del pieces[pi]
                if p[1] < b[1]:
                    pieces.append([p[0], p[1], b[1] - 1, -1])
                if p[2] > b[2]:
                    pieces.append([p[0], b[2] + 1, p[2], -1])
    return overlap_ids, pieces


# -- breakpoint canonicalization (reference :289-295) ----------------------

def interval_to_bp(r1, r2, r=(), rgap: int = 0) -> list:
    """Canonicalize a split-alignment junction into a breakpoint row.

    Side 1 is the 3' end of the first alignment, side 2 the 5' start of the
    second, ordered by chromosome index then position, with the second
    side's strand flipped.
    """
    if (CHR_IDX[r2[0]] < CHR_IDX[r1[0]]) or (
        CHR_IDX[r2[0]] == CHR_IDX[r1[0]] and r2[1] < r1[2]
    ):
        return [r1[0], r1[2], r1[3], r2[0], r2[1], FLIP_STRAND[r2[3]], r, rgap, 0]
    return [r2[0], r2[1], FLIP_STRAND[r2[3]], r1[0], r1[2], r1[3],
            (r[0], r[2], r[1]), rgap, 1]


# -- per-read breakpoint extraction (reference :70-249) --------------------

def _pair_passes_nm(nm, i, j, max_nm) -> bool:
    return max_nm is None or (nm[i] < max_nm and nm[j] < max_nm)


def rescue_pass(rn, q, r, mq, nm, assigned, pair_in, out, *,
                min_mapq, gap_mapq, max_nm,
                gap_=None, min_bp_match_cutoff=None):
    """Low-mapq middle-alignment rescue — the reference's "i-1, i+1" pass,
    shared by all four extraction paths (two-interval form
    ``alignment2bp``:100-125, no same-strand clause; interval-list form
    ``alignment2bp_l``:190-249, ``gap_`` set, same-strand gap-discrepancy
    clause applies).  ``pair_in(a, b)`` tests interval membership of rows
    a and b.  All gates are pure conjunctions, so the small evaluation-
    order differences between the reference variants are output-neutral.
    """
    for i in range(1, len(r) - 1):
        if assigned[i - 1] or assigned[i]:
            continue
        if not (mq[i] < gap_mapq and mq[i - 1] >= min_mapq
                and mq[i + 1] >= min_mapq):
            continue
        if not pair_in(i - 1, i + 1):
            continue
        if not _pair_passes_nm(nm, i - 1, i + 1, max_nm):
            continue
        if gap_ is not None and not _same_interval_pair_ok(
                q, r, i - 1, i + 1, gap_, min_bp_match_cutoff):
            continue
        qgap = int(q[i + 1][0]) - int(q[i - 1][1])
        out.append(interval_to_bp(r[i - 1], r[i + 1], (rn, i - 1, i + 1),
                                  qgap) + [mq[i - 1], mq[i + 1]])


def chimera_to_bps(
    rn: str,
    chim,
    min_bp_match_cutoff: int,
    min_mapq: float,
    intrvl1,
    intrvl2,
    gap_mapq: float = 10,
    max_nm: Optional[float] = None,
) -> List[list]:
    """Two-interval variant (``alignment2bp``/``alignment2bp_nm``,
    reference ``:70-126``): emit junctions with one side in each interval.
    """
    q, r, mq, nm = chim.q, chim.r, chim.mapq, chim.nm
    out: List[list] = []
    assigned = [0] * max(len(r) - 1, 0)
    for i in range(len(r) - 1):
        qgap = int(q[i + 1][0]) - int(q[i][1])
        if qgap + min_bp_match_cutoff < 0:
            continue
        pair_in = (
            (interval_overlap(r[i], intrvl1) and interval_overlap(r[i + 1], intrvl2))
            or (interval_overlap(r[i + 1], intrvl1) and interval_overlap(r[i], intrvl2))
        )
        if pair_in and mq[i] >= min_mapq and mq[i + 1] >= min_mapq and \
                _pair_passes_nm(nm, i, i + 1, max_nm):
            out.append(interval_to_bp(r[i], r[i + 1], (rn, i, i + 1), qgap)
                       + [mq[i], mq[i + 1]])
            assigned[i] = 1
    rescue_pass(
        rn, q, r, mq, nm, assigned,
        lambda a, b: (
            (interval_overlap(r[a], intrvl1) and interval_overlap(r[b], intrvl2))
            or (interval_overlap(r[b], intrvl1) and interval_overlap(r[a], intrvl2))),
        out, min_mapq=min_mapq, gap_mapq=gap_mapq, max_nm=max_nm)
    return out


def _same_interval_pair_ok(q, r, i, j, gap_, min_bp_match_cutoff) -> bool:
    """Same-interval-list junction test: strand flip, or ref/read gap
    discrepancy beyond max(gap_, 20% of the read gap) (reference
    ``:145-161``)."""
    if r[j][3] != r[i][3]:
        return True
    gr = int(q[j][0]) - int(q[i][1])
    if r[j][3] == "+":
        grr = int(r[j][1]) - int(r[i][2])
    else:
        grr = int(r[i][2]) - int(r[j][1])
    return abs(gr - grr) > max(gap_, abs(gr * 0.2))


def chimera_to_bps_l(
    rn: str,
    chim,
    min_bp_match_cutoff: int,
    min_mapq: float,
    gap_: float,
    intervals: Sequence,
    gap_mapq: float = 10,
    max_nm: Optional[float] = None,
) -> List[list]:
    """Interval-list variant (``alignment2bp_l``/``alignment2bp_nm_l``,
    reference ``:129-249``): both sides must land in the SAME interval of
    the list; same-strand pairs additionally need a gap discrepancy.
    """
    q, r, mq, nm = chim.q, chim.r, chim.mapq, chim.nm
    out: List[list] = []
    assigned = [0] * max(len(r) - 1, 0)
    for i in range(len(r) - 1):
        j = i + 1
        qgap = int(q[j][0]) - int(q[i][1])
        if qgap + min_bp_match_cutoff < 0:
            continue
        io1 = interval_overlap_l(r[i], intervals)
        io2 = interval_overlap_l(r[j], intervals)
        if io1 < 0 or io2 < 0 or io1 != io2:
            continue
        if r[j][3] != r[i][3]:
            if mq[i] >= min_mapq and mq[j] >= min_mapq and \
                    _pair_passes_nm(nm, i, j, max_nm):
                out.append(interval_to_bp(r[i], r[j], (rn, i, j), qgap)
                           + [mq[i], mq[j]])
                assigned[i] = 1
        elif _same_interval_pair_ok(q, r, i, j, gap_, min_bp_match_cutoff):
            if mq[i] >= min_mapq and mq[j] >= min_mapq and \
                    _pair_passes_nm(nm, i, j, max_nm):
                out.append(interval_to_bp(r[i], r[j], (rn, i, j), qgap)
                           + [mq[i], mq[j]])
                assigned[i] = 1
    def _same_list(a, b):
        io1 = interval_overlap_l(r[a], intervals)
        io2 = interval_overlap_l(r[b], intervals)
        return io1 >= 0 and io2 >= 0 and io1 == io2

    rescue_pass(
        rn, q, r, mq, nm, assigned, _same_list, out,
        min_mapq=min_mapq, gap_mapq=gap_mapq, max_nm=max_nm,
        gap_=gap_, min_bp_match_cutoff=min_bp_match_cutoff)
    return out


# -- clustering (reference :252-286) ---------------------------------------

class _PosBuffer:
    """Amortized-growth (pos1, pos2) arrays for one cluster.

    The membership test is exact (any member within ``cutoff`` on both
    coordinates) but engineered for WGS-scale groups, where the naive
    full scan made first-fit clustering quadratic (round-4 profile:
    the top host hotspot on junction-heavy samples):

    * a **bounding box** rejects non-members in O(1) — distinct
      junctions in the same (chr, orientation) group are typically far
      apart, so cross-cluster probes never touch the arrays;
    * a **prefix probe** over the first 32 members accepts same-junction
      members in O(1) — jittered observations of one junction all match
      the cluster's earliest members;
    * only the rare in-box prefix-miss pays the full vectorized scan.
    """

    __slots__ = ("a1", "a2", "n", "lo1", "hi1", "lo2", "hi2", "f1", "f2")

    def __init__(self, p1: int, p2: int):
        self.a1 = np.empty(8, np.int64)
        self.a2 = np.empty(8, np.int64)
        self.a1[0] = p1
        self.a2[0] = p2
        self.n = 1
        self.lo1 = self.hi1 = p1
        self.lo2 = self.hi2 = p2
        self.f1 = p1     # founder coords: scalar fast-path probe
        self.f2 = p2

    def add(self, p1: int, p2: int) -> None:
        if self.n == len(self.a1):
            self.a1 = np.resize(self.a1, 2 * self.n)
            self.a2 = np.resize(self.a2, 2 * self.n)
        self.a1[self.n] = p1
        self.a2[self.n] = p2
        self.n += 1
        if p1 < self.lo1:
            self.lo1 = p1
        elif p1 > self.hi1:
            self.hi1 = p1
        if p2 < self.lo2:
            self.lo2 = p2
        elif p2 > self.hi2:
            self.hi2 = p2

    def hits(self, p1: int, p2: int, cutoff: int) -> bool:
        if p1 <= self.lo1 - cutoff or p1 >= self.hi1 + cutoff \
                or p2 <= self.lo2 - cutoff or p2 >= self.hi2 + cutoff:
            return False
        # founder probe: pure-int accept for the dominant same-junction
        # case (no numpy call)
        if -cutoff < p1 - self.f1 < cutoff and \
                -cutoff < p2 - self.f2 < cutoff:
            return True
        k = 32 if self.n > 32 else self.n
        a1 = self.a1[:k]
        a2 = self.a2[:k]
        if bool(((np.abs(a1 - p1) < cutoff)
                 & (np.abs(a2 - p2) < cutoff)).any()):
            return True
        if self.n <= 32:
            return False
        a1 = self.a1[32: self.n]
        a2 = self.a2[32: self.n]
        return bool(((np.abs(a1 - p1) < cutoff)
                     & (np.abs(a2 - p2) < cutoff)).any())


def _firstfit_ids(p1: np.ndarray, p2: np.ndarray,
                  distance_cutoff: int) -> Optional[np.ndarray]:
    """Native first-fit cluster ids (creation order) or None when the
    library is unavailable; bit-identical to the _PosBuffer scan."""
    try:
        from ..native.bamcore import cluster_firstfit
        return cluster_firstfit(p1, p2, distance_cutoff)
    except OSError:
        return None


def _cluster_group_host(members: List[list],
                        distance_cutoff: int) -> List[List[list]]:
    if len(members) >= 64:
        p1 = np.fromiter((m[1] for m in members), np.int64, len(members))
        p2 = np.fromiter((m[4] for m in members), np.int64, len(members))
        cids = _firstfit_ids(p1, p2, distance_cutoff)
        if cids is not None:
            sub = [[] for _ in range(int(cids.max()) + 1)]
            for m, c in zip(members, cids.tolist()):
                sub[c].append(m)
            return sub
    sub: List[List[list]] = []
    sub_pos: List[_PosBuffer] = []
    for bp in members:
        target = -1
        p1, p2 = int(bp[1]), int(bp[4])
        for ci in range(len(sub)):
            if sub_pos[ci].hits(p1, p2, distance_cutoff):
                target = ci
                break
        if target >= 0:
            sub[target].append(bp)
            sub_pos[target].add(p1, p2)
        else:
            sub.append([bp])
            sub_pos.append(_PosBuffer(p1, p2))
    return sub


# device-path group-size cap: the (n, n) uint8 match matrix must stay
# modest (4096**2 = 16 MB to copy back); larger groups take the host path
_DEVICE_GROUP_CAP = 4096


def _cluster_group_device(members: List[list], distance_cutoff: int,
                          engine: str, device) -> List[List[list]]:
    """Exact first-fit clustering with the pairwise-match test done as one
    match matrix on ``device``: by the kernel K9 (``engine='cuda'``) or by
    its plain version (``engine='torch'``).

    Equivalence to the sequential scan: breakpoint ``i`` joins the
    first-created cluster with any matching member, which equals
    ``min(cluster_of[j])`` over earlier matches ``j`` — every cluster's
    members are exactly the breakpoints assigned to it, and it matches
    ``i`` iff one of them does.
    """
    import torch

    from .kernels import match_matrix, match_matrix_torch

    p1 = np.asarray([int(bp[1]) for bp in members], np.int64)
    p2 = np.asarray([int(bp[4]) for bp in members], np.int64)
    if (np.abs(p1) >= 2**31 - 1).any() or (np.abs(p2) >= 2**31 - 1).any() \
            or not 0 <= distance_cutoff < 2**31:
        return _cluster_group_host(members, distance_cutoff)
    fn = match_matrix if engine == "cuda" else match_matrix_torch
    mat = fn(torch.from_numpy(p1.astype(np.int32)).to(device),
             torch.from_numpy(p2.astype(np.int32)).to(device),
             int(distance_cutoff)).cpu().numpy()
    cluster_of = np.empty(len(members), np.int32)
    sub: List[List[list]] = []
    for i, bp in enumerate(members):
        cand = np.nonzero(mat[i, :i])[0]
        if cand.size:
            t = int(cluster_of[cand].min())
            cluster_of[i] = t
            sub[t].append(bp)
        else:
            cluster_of[i] = len(sub)
            sub.append([bp])
    return sub


def cluster_breakpoints(
    bp_list: List[list],
    min_cluster_size: float,
    distance_cutoff: int,
    engine: str = "host",
    *,
    device="cuda",
) -> List[List[list]]:
    """Greedy first-fit clustering keyed by (chr1, chr2, o1, o2).

    Preserves the reference's exact assignment rule: each breakpoint joins
    the FIRST existing cluster (in creation order) containing any member
    within ``distance_cutoff`` on both coordinates; groups smaller than
    ``min_cluster_size`` pass through as single clusters.

    ``engine='cuda'`` (``engine='pallas'`` in the JAX package) takes the
    pairwise membership tests of a group from the match-matrix kernel K9 on
    the CUDA device ``device`` and raises without one; ``engine='torch'``
    takes them from the kernel's plain version on ``device``, CPU or CUDA.
    The output is identical; groups above the size cap, or with positions
    outside int32, take the host scan.  ``engine='host'`` ignores
    ``device``.
    """
    if engine not in ("host", "torch", "cuda"):
        raise ValueError(f"unknown engine {engine!r} (host, torch or cuda)")
    if engine != "host":
        from ..device import resolve_device

        device = resolve_device(device)
        if engine == "cuda" and device.type != "cuda":
            raise ValueError(f"engine='cuda' needs a CUDA device, not "
                             f"{device}")
    groups: dict = {}
    for bp in bp_list:
        groups.setdefault((bp[0], bp[3], bp[2], bp[5]), []).append(bp)
    clusters: List[List[list]] = []
    for key, members in groups.items():
        if len(members) < min_cluster_size:
            clusters.append(members)
            continue
        if engine != "host" and len(members) <= _DEVICE_GROUP_CAP:
            clusters.extend(_cluster_group_device(members, distance_cutoff,
                                                  engine, device))
        else:
            clusters.extend(_cluster_group_host(members, distance_cutoff))
    return clusters


# -- breakpoint matching (reference :391-415) ------------------------------

def bp_match(bp1, bp2, rgap, cutoffs) -> bool:
    """Check two canonical breakpoints for identity within cutoffs,
    optionally spending the read gap toward strand-consistent offsets."""
    if not (bp1[0] == bp2[0] and bp1[3] == bp2[3]
            and bp1[2] == bp2[2] and bp1[5] == bp2[5]):
        return False
    if rgap <= 0:
        return (abs(int(bp1[1]) - int(bp2[1])) < cutoffs[0]
                and abs(int(bp1[4]) - int(bp2[4])) < cutoffs[1])
    rgap_ = rgap
    consumed = [0, 0]
    if bp1[2] == "+" and int(bp1[1]) <= int(bp2[1]) - cutoffs[0]:
        rgap_ -= (int(bp2[1]) - cutoffs[0] - int(bp1[1]) + 1)
        consumed[0] = 1
    if bp1[2] == "-" and int(bp1[1]) >= int(bp2[1]) + cutoffs[0]:
        rgap_ -= (int(bp1[1]) - int(bp2[1]) - cutoffs[0] + 1)
        consumed[0] = 1
    if bp1[5] == "+" and int(bp1[4]) <= int(bp2[4]) - cutoffs[1]:
        rgap_ -= (int(bp2[4]) - cutoffs[1] - int(bp1[4]) + 1)
        consumed[1] = 1
    if bp1[5] == "-" and int(bp1[4]) >= int(bp2[4]) + cutoffs[1]:
        rgap_ -= (int(bp1[4]) - int(bp2[4]) - cutoffs[1] + 1)
        consumed[1] = 1
    return (((consumed[0] == 1 and rgap_ >= 0)
             or abs(int(bp1[1]) - int(bp2[1])) < cutoffs[0])
            and ((consumed[1] == 1 and rgap_ >= 0)
                 or abs(int(bp1[4]) - int(bp2[4])) < cutoffs[1]))


# -- consensus call (reference :299-388) -----------------------------------

def _consensus_coord(vals, strand: str) -> int:
    """Mode if unique, else parity-dependent rounded median (reference
    ``:336-357``; ties in the mode fall back to the median).

    Accepts a list or an int ndarray.  The mode test is order-free (the
    reference's ``most_common`` result is used only when the top count
    is STRICTLY greater than the runner-up, so insertion-order
    tie-breaks never reach the output), which is what lets it vectorize
    as ``np.unique(return_counts=True)`` — a Counter over a ~150k-member
    cluster cost ~10 ms per consensus call (round-5 profile)."""
    v = np.asarray(vals, np.int64)
    uniq, counts = np.unique(v, return_counts=True)
    mx = int(np.argmax(counts))
    if len(uniq) == 1 or int((counts == counts[mx]).sum()) == 1:
        return int(uniq[mx])
    if len(v) % 2 == 1:
        return int(np.median(v))
    if strand == "+":
        return int(math.ceil(np.median(v)))
    return int(math.floor(np.median(v)))


def call_consensus_bp(
    cluster: List[list], distance_cutoff: int
) -> Tuple[list, list, list, List[list]]:
    """Call the exact breakpoint of a cluster.

    Returns (bp, supporting_reads, stats, leftover_cluster):
      bp        consensus 9-field row,
      reads     ``r`` tuples of members matching the consensus,
      stats     [avg1, avg2, std1, std2, mapq1, mapq2] over matched members,
      leftover  unmatched members (re-clustered by the caller's while loop).
    """
    bp = list(cluster[0][:-2])
    bp[1] = 0 if bp[2] == "+" else 1000000000
    bp[4] = 0 if bp[5] == "+" else 1000000000
    # moment accumulation is SEQUENTIAL python-float arithmetic to match
    # the reference's rounding bit-for-bit (ref :310-323): positions are
    # ~1e8 so E[x^2] - E[x]^2 cancels catastrophically and the emitted
    # digits depend on the summation order (numpy pairwise sums differ)
    # accumulate in python ints (exact, like the reference's [0,0,0,0]
    # accumulators); the single rounding happens at the division
    if len(cluster) > 512:
        # WGS-scale clusters: exact chunked int64 accumulation — per-chunk
        # sums of p*p (< 2^56 each) stay under 2^63 for chunks <= 127
        # elements, and the chunk totals sum in python ints (exact, so
        # the value equals the sequential python-int accumulation above)
        p1a = np.asarray([int(b[1]) for b in cluster], np.int64)
        p2a = np.asarray([int(b[4]) for b in cluster], np.int64)
        # shared with the table path so both stay value-identical at
        # large-genome coordinates (chunk cap guards p*p overflow)
        a1 = _exact_int_sum(p1a)
        a2 = _exact_int_sum(p2a)
        q1sum = _exact_int_sum(p1a * p1a)
        q2sum = _exact_int_sum(p2a * p2a)
    else:
        a1 = a2 = q1sum = q2sum = 0
        for b in cluster:
            p1, p2 = int(b[1]), int(b[4])   # python ints: no np.int64 wrap
            a1 += p1
            q1sum += p1 * p1
            a2 += p2
            q2sum += p2 * p2
    ncl = len(cluster) * 1.0
    m1, m2 = a1 / ncl, a2 / ncl
    e1, e2 = q1sum / ncl, q2sum / ncl
    floor = distance_cutoff / 2.99
    s1 = max(floor, math.sqrt(e1 - m1 * m1)) if e1 >= m1 * m1 else floor
    s2 = max(floor, math.sqrt(e2 - m2 * m2)) if e2 >= m2 * m2 else floor
    p1s = np.asarray([b[1] for b in cluster], dtype=np.float64)
    p2s = np.asarray([b[4] for b in cluster], dtype=np.float64)
    keep = (p1s <= m1 + 3 * s1) & (p1s >= m1 - 3 * s1) & \
           (p2s <= m2 + 3 * s2) & (p2s >= m2 - 3 * s2)
    kept1 = [int(cluster[i][1]) for i in range(len(cluster)) if keep[i]]
    kept2 = [int(cluster[i][4]) for i in range(len(cluster)) if keep[i]]
    if kept1:
        bp[1] = _consensus_coord(kept1, bp[2])
    if kept2:
        bp[4] = _consensus_coord(kept2, bp[5])
    # vectorized bp_match of every member against the consensus: all
    # members share the cluster's strand key, so the strand branches of
    # bp_match (ref :402-413) are uniform and the per-member arithmetic
    # vectorizes exactly
    mp1 = np.asarray([int(m[1]) for m in cluster], np.int64)
    mp2 = np.asarray([int(m[4]) for m in cluster], np.int64)
    rgap = np.asarray([m[7] for m in cluster], np.float64) * 1.2
    c0 = c1 = distance_cutoff
    near1 = np.abs(mp1 - bp[1]) < c0
    near2 = np.abs(mp2 - bp[4]) < c1
    simple = near1 & near2
    if bp[2] == "+":
        cons0 = mp1 <= bp[1] - c0
        sub0 = (bp[1] - c0 - mp1 + 1)
    else:
        cons0 = mp1 >= bp[1] + c0
        sub0 = (mp1 - bp[1] - c0 + 1)
    if bp[5] == "+":
        cons1 = mp2 <= bp[4] - c1
        sub1 = (bp[4] - c1 - mp2 + 1)
    else:
        cons1 = mp2 >= bp[4] + c1
        sub1 = (mp2 - bp[4] - c1 + 1)
    rgap_left = rgap - cons0 * sub0 - cons1 * sub1
    complex_match = ((cons0 & (rgap_left >= 0)) | near1) & \
                    ((cons1 & (rgap_left >= 0)) | near2)
    matched = np.where(rgap <= 0, simple, complex_match)

    reads = [cluster[i][6] for i in np.flatnonzero(matched)]
    leftover = [cluster[i] for i in np.flatnonzero(~matched)]
    if not reads:
        return bp, reads, [0, 0, 0, 0, 0, 0], []
    # exact int accumulation again (ref :310,365-387) — see comment above
    st = [0, 0, 0, 0, 0, 0]
    for i in np.flatnonzero(matched):
        m = cluster[i]
        p1, p2 = int(m[1]), int(m[4])
        st[0] += p1
        st[2] += p1 * p1
        st[1] += p2
        st[3] += p2 * p2
        if m[-3] == 0:
            st[4] += m[-2]
            st[5] += m[-1]
        else:
            st[4] += m[-1]
            st[5] += m[-2]
    n = len(reads) * 1.0
    for i in range(6):
        st[i] /= n
    st[2] = math.sqrt(st[2] - st[0] * st[0]) if st[2] >= st[0] * st[0] else 0
    st[3] = math.sqrt(st[3] - st[1] * st[1]) if st[3] >= st[1] * st[1] else 0
    return bp, reads, st, leftover


# -- struct-of-arrays observation table (TPU-first addition) ---------------
#
# The row-based pipeline above is the exact per-row semantics; at WGS
# junction counts (~1.5M observations per pass) building a Python list
# per observation and re-extracting columns inside clustering/consensus
# dominated reconstruct wall time (round-4 profile).  BpTable keeps the
# observations as flat columns end-to-end; clustering and consensus
# below are COLUMN-ORDER-IDENTICAL re-expressions of
# cluster_breakpoints/call_consensus_bp (same first-fit assignment, same
# exact-integer moment accumulation, same mode/median consensus), and
# Python rows materialize only for the consensus outputs (dozens).
# Equality with the row pipeline is pinned by tests/test_bptable.py.

class BpTable:
    """Flat-column breakpoint observations (row layout docstring above).

    ``s1``/``s2`` hold the canonical orientations as booleans ('+' is
    True); ``ti``/``tj`` are the two alignment indices of the ``r``
    tuple; ``names`` maps ``ridx`` to read names.  Rows whose ``r``
    tuple cannot be expressed as (names[ridx], ti, tj) — e.g. spliced
    rescue rows — carry their prebuilt tuple in ``tup`` keyed by row
    position (ridx -1 there).
    """

    __slots__ = ("c1", "p1", "s1", "c2", "p2", "s2", "ridx", "ti", "tj",
                 "rgap", "flip", "q1", "q2", "names", "tup")

    def __init__(self, c1, p1, s1, c2, p2, s2, ridx, ti, tj,
                 rgap, flip, q1, q2, names, tup=None):
        self.c1, self.p1, self.s1 = c1, p1, s1
        self.c2, self.p2, self.s2 = c2, p2, s2
        self.ridx, self.ti, self.tj = ridx, ti, tj
        self.rgap, self.flip, self.q1, self.q2 = rgap, flip, q1, q2
        self.names = names
        self.tup = tup or {}

    def __len__(self):
        return len(self.p1)

    def rtuple(self, k: int):
        t = self.tup.get(k)
        if t is not None:
            return t
        return (self.names[int(self.ridx[k])], int(self.ti[k]),
                int(self.tj[k]))

    def row(self, k: int) -> list:
        code_to_name = _code_to_name()
        return [code_to_name[int(self.c1[k])], int(self.p1[k]),
                "+" if self.s1[k] else "-",
                code_to_name[int(self.c2[k])], int(self.p2[k]),
                "+" if self.s2[k] else "-",
                self.rtuple(k), int(self.rgap[k]), int(self.flip[k]),
                int(self.q1[k]), int(self.q2[k])]

    def rows(self) -> List[list]:
        return [self.row(k) for k in range(len(self))]

    @staticmethod
    def from_rows(rows: List[list], names=None) -> "BpTable":
        n = len(rows)
        tb = BpTable(
            np.fromiter((CHR_IDX[r[0]] for r in rows), np.int32, n),
            np.fromiter((r[1] for r in rows), np.int64, n),
            np.fromiter((r[2] == "+" for r in rows), bool, n),
            np.fromiter((CHR_IDX[r[3]] for r in rows), np.int32, n),
            np.fromiter((r[4] for r in rows), np.int64, n),
            np.fromiter((r[5] == "+" for r in rows), bool, n),
            np.full(n, -1, np.int64),
            np.zeros(n, np.int64), np.zeros(n, np.int64),
            np.fromiter((r[7] for r in rows), np.int64, n),
            np.fromiter((r[8] for r in rows), np.int8, n),
            np.fromiter((r[9] for r in rows), np.int64, n),
            np.fromiter((r[10] for r in rows), np.int64, n),
            names or [],
            {k: rows[k][6] for k in range(n)})
        return tb


_CODE_TO_NAME = None


def _code_to_name():
    global _CODE_TO_NAME
    if _CODE_TO_NAME is None:
        m = [None] * (max(CHR_IDX.values()) + 1)
        for name, code in CHR_IDX.items():
            m[code] = name
        _CODE_TO_NAME = m
    return _CODE_TO_NAME


def _exact_int_sum(v: np.ndarray) -> int:
    """Exact integer sum of an int64 array (equals python-int sequential
    accumulation).

    Chunk size is capped so per-chunk int64 partial sums cannot
    overflow: for squared coordinates p*p the historical fixed chunk of
    127 overflows 2^63 once p > ~2.69e8 (safe for human chr1 at 2.49e8,
    not for wheat/axolotl-scale references).  For human-scale values
    (max <= 7.26e16) the cap resolves to the same 127, so results are
    unchanged where the old code was already exact."""
    if len(v) == 0:
        return 0
    mx = int(np.abs(v).max())
    chunk = 127 if mx == 0 else min(127, (2**63 - 1) // mx)
    if chunk < 1:
        return sum(int(x) for x in v)
    return int(sum(int(x) for x in np.add.reduceat(
        v, range(0, len(v), chunk))))


def cluster_breakpoints_t(
    tb: BpTable,
    min_cluster_size: float,
    distance_cutoff: int,
) -> List[np.ndarray]:
    """`cluster_breakpoints` over a BpTable; returns index arrays.

    Group key, group first-occurrence order, member order within a
    group, and the first-fit assignment are identical to the row
    implementation (same _PosBuffer membership test)."""
    n = len(tb)
    if n == 0:
        return []
    key = (((tb.c1.astype(np.int64) * (len(_code_to_name()) + 1)
             + tb.c2) * 2 + tb.s1) * 2 + tb.s2)
    order = np.argsort(key, kind="stable")
    sk = key[order]
    gb = np.ones(n, bool)
    gb[1:] = sk[1:] != sk[:-1]
    gstart = np.flatnonzero(gb)
    gend = np.append(gstart[1:], n)
    # groups in first-occurrence order (dict-insertion order of the row
    # implementation): order[gstart] is each group's earliest row
    gorder = np.argsort(order[gstart], kind="stable")
    clusters: List[np.ndarray] = []
    for g in gorder.tolist():
        idx = order[gstart[g]:gend[g]]
        if len(idx) < min_cluster_size:
            clusters.append(idx)
            continue
        cids = _firstfit_ids(tb.p1[idx], tb.p2[idx], distance_cutoff)
        if cids is not None:
            # stable sort by creation-ordered id = clusters in creation
            # order, members in original order
            o2 = np.argsort(cids, kind="stable")
            sc = cids[o2]
            starts = np.flatnonzero(np.concatenate(
                [[True], sc[1:] != sc[:-1]]))
            ends = np.append(starts[1:], len(sc))
            clusters.extend(idx[o2[a:b]] for a, b in zip(starts, ends))
            continue
        p1_l = tb.p1[idx].tolist()
        p2_l = tb.p2[idx].tolist()
        sub: List[List[int]] = []
        sub_pos: List[_PosBuffer] = []
        for m in range(len(idx)):
            p1, p2 = p1_l[m], p2_l[m]
            target = -1
            for ci in range(len(sub)):
                if sub_pos[ci].hits(p1, p2, distance_cutoff):
                    target = ci
                    break
            if target >= 0:
                sub[target].append(m)
                sub_pos[target].add(p1, p2)
            else:
                sub.append([m])
                sub_pos.append(_PosBuffer(p1, p2))
        clusters.extend(idx[np.asarray(m, np.int64)] for m in sub)
    return clusters


def call_consensus_bp_t(
    tb: BpTable, idx: np.ndarray, distance_cutoff: int
) -> Tuple[list, list, list, np.ndarray]:
    """`call_consensus_bp` over BpTable indices.

    Value-identical to the row implementation: all integer moments use
    exact accumulation (the row code's python-int / chunked paths both
    compute the exact sum, so one exact path matches both), float
    operations happen in the same order, and member order is ``idx``
    order throughout.  Returns leftover as an index array."""
    k0 = int(idx[0])
    code_to_name = _code_to_name()
    s1 = "+" if tb.s1[k0] else "-"
    s2 = "+" if tb.s2[k0] else "-"
    bp = [code_to_name[int(tb.c1[k0])],
          0 if s1 == "+" else 1000000000, s1,
          code_to_name[int(tb.c2[k0])],
          0 if s2 == "+" else 1000000000, s2,
          tb.rtuple(k0), int(tb.rgap[k0]), int(tb.flip[k0])]
    p1a = tb.p1[idx]
    p2a = tb.p2[idx]
    ncl = len(idx) * 1.0
    a1 = _exact_int_sum(p1a)
    a2 = _exact_int_sum(p2a)
    q1sum = _exact_int_sum(p1a * p1a)
    q2sum = _exact_int_sum(p2a * p2a)
    m1, m2 = a1 / ncl, a2 / ncl
    e1, e2 = q1sum / ncl, q2sum / ncl
    floor = distance_cutoff / 2.99
    std1 = max(floor, math.sqrt(e1 - m1 * m1)) if e1 >= m1 * m1 else floor
    std2 = max(floor, math.sqrt(e2 - m2 * m2)) if e2 >= m2 * m2 else floor
    p1f = p1a.astype(np.float64)
    p2f = p2a.astype(np.float64)
    keep = (p1f <= m1 + 3 * std1) & (p1f >= m1 - 3 * std1) & \
           (p2f <= m2 + 3 * std2) & (p2f >= m2 - 3 * std2)
    kept1 = p1a[keep]
    kept2 = p2a[keep]
    if kept1.size:
        bp[1] = _consensus_coord(kept1, bp[2])
    if kept2.size:
        bp[4] = _consensus_coord(kept2, bp[5])
    rgap = tb.rgap[idx].astype(np.float64) * 1.2
    c0 = c1 = distance_cutoff
    near1 = np.abs(p1a - bp[1]) < c0
    near2 = np.abs(p2a - bp[4]) < c1
    simple = near1 & near2
    if bp[2] == "+":
        cons0 = p1a <= bp[1] - c0
        sub0 = (bp[1] - c0 - p1a + 1)
    else:
        cons0 = p1a >= bp[1] + c0
        sub0 = (p1a - bp[1] - c0 + 1)
    if bp[5] == "+":
        cons1 = p2a <= bp[4] - c1
        sub1 = (bp[4] - c1 - p2a + 1)
    else:
        cons1 = p2a >= bp[4] + c1
        sub1 = (p2a - bp[4] - c1 + 1)
    rgap_left = rgap - cons0 * sub0 - cons1 * sub1
    complex_match = ((cons0 & (rgap_left >= 0)) | near1) & \
                    ((cons1 & (rgap_left >= 0)) | near2)
    matched = np.where(rgap <= 0, simple, complex_match)
    midx = idx[matched]
    leftover = idx[~matched]
    # bulk tuple build (rtuple per member costs ~1us in dict-get +
    # scalar casts; clusters run to ~150k members at WGS junction counts)
    names = tb.names
    tup = tb.tup
    reads = [tup.get(k) or (names[r], a, b) for k, r, a, b in
             zip(midx.tolist(), tb.ridx[midx].tolist(),
                 tb.ti[midx].tolist(), tb.tj[midx].tolist())] \
        if tup else \
        [(names[r], a, b) for r, a, b in
         zip(tb.ridx[midx].tolist(), tb.ti[midx].tolist(),
             tb.tj[midx].tolist())]
    if not reads:
        # zero-match consensus: empty leftover, matching the row path
        # above and the reference (breakpoint_utilities.py:375-376) —
        # returning the full cluster here makes the caller's
        # `while len(remainder) >= cutoff` loop a fixed point (hang)
        return bp, reads, [0, 0, 0, 0, 0, 0], leftover[:0]
    mp1 = tb.p1[midx]
    mp2 = tb.p2[midx]
    flips = tb.flip[midx] != 0
    q1m = np.where(flips, tb.q2[midx], tb.q1[midx])
    q2m = np.where(flips, tb.q1[midx], tb.q2[midx])
    st = [_exact_int_sum(mp1), _exact_int_sum(mp2),
          _exact_int_sum(mp1 * mp1), _exact_int_sum(mp2 * mp2),
          _exact_int_sum(q1m.astype(np.int64)),
          _exact_int_sum(q2m.astype(np.int64))]
    n_m = len(reads) * 1.0
    for i in range(6):
        st[i] /= n_m
    st[2] = math.sqrt(st[2] - st[0] * st[0]) if st[2] >= st[0] * st[0] else 0
    st[3] = math.sqrt(st[3] - st[1] * st[1]) if st[3] >= st[1] * st[1] else 0
    return bp, reads, st, leftover
