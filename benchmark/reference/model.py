"""Plain NumPy reference of ``reconstruct`` on a planted sample.

Everything the program derives from the BAM, the CN segments and the seed
interval is worked out here again from the records the generator planted
(:func:`planted_records`: every alignment's reference span, its deletions
and its read, with the seed's junction geometry) and from the CN segment
and seed files:

* the diploid coverage: CoRAL's rule (``infer_breakpoint_graph.py:110-136``),
  segments taken around the median log2 until 10 Mb, aligned bases over
  their length;
* the amplicon interval: the CN segments holding the seed's ends, widened
  by ``interval_delta`` where that stays inside the segment table
  (``:213-240``); the planted junctions' alignments all lie inside one CN
  segment, so no breakpoint search extends it;
* each junction's breakpoint: CoRAL's consensus over its reads
  (``:299-388``): members within three deviations of the mean (at least
  ``distance_cutoff / 2.99``), then each end's mode where it is unique, else
  the median rounded by the read count's parity and the end's strand.  A
  split junction's ends are its alignments' ends; a deletion's are its
  CIGAR gap, first block's end and next block's start, where the gap is
  over ``min_del_len`` (``:721-802``).  A junction has a breakpoint
  where it has at least ``max(3, min_bp_support * diploid coverage)``
  reads.  The end at the larger position comes first, as the program
  writes it;
* each amplicon's graph: sequence edges split at every breakpoint end, a
  concordant edge at every split, one discordant edge a junction, with
  every read count and aligned-base total (``assign_cov``, ``:1019-1056``):
  a concordant edge counts the reads through both its flanks that support
  no discordant edge at its two nodes;
* the CN balance (``breakpoint_graph.py:495-606``): the convex program
  ``min sum w_i/x_i + c_i x_i - l_i log x_i`` with flow balance ``A x = 0``
  at every inner node, as the program poses it (``graph/cn_solver.py``: a
  KKT system whose constraint block carries ``-penalty * I``, so that its
  solution is that of the balance held by the quadratic penalty
  ``|A x|^2 / (2 penalty)``), solved here by Newton steps on that system
  to the precision of the dtype given;
* the path constraints (``path_constraints.py:10-301, 378-417``;
  ``infer_breakpoint_graph.py:1085-1323``): each junction read's walk
  through its discordant edge, and each other read's walk over the
  sequence edges it overlaps by ``min_overlap``, kept where it holds three
  sequence edges or more, counted once with its reversal, then only the
  walks no other one contains;
* the cycle decomposition.  A one-segment circle: the planted circle
  through its segment at the junction's copy number, and the chromosome's
  path where the circle leaves more than ``1 - p_total_weight`` of the
  CN-weighted length.  Any other amplicon: the circles the mix lists and,
  where they leave that much or leave a path constraint unmet, the
  chromosome's path, at the copy counts that cover the most CN-weighted
  length within every edge's CN (a linear program over these walks,
  solved at its vertices).  Where the amplicon has more than one walk
  CoRAL's model does not fix their copy counts, so the check holds only
  the count of walks, the circles' segment lists, the constraints met,
  the length covered and the edges' CN caps.

Imports nothing of the program.
"""
from __future__ import annotations

import itertools
import math
import os
import sys
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "traffic"))
from generator import (junction_reads, shape, split_alignments,  # noqa: E402
                       tiled_cigar, tiled_reads)

MIN_DEL_LEN = 600        # CoRAL's default, where a configuration states none
MIN_OVERLAP = 500        # path_constraints.py:48, CoRAL's default
MIN_CLUSTER = 3          # the fewest reads a breakpoint has, CoRAL's default


@dataclass
class Junction:
    """A planted junction's reads: their ids, and each read's two
    alignments as (first base, last base, strand), first the one that
    reaches end 1.  A deletion read's are its two blocks, the first one's
    last base given as its exclusive end, as CoRAL's small-deletion rule
    reads it.  ``first``/``second`` are the observed ends in CoRAL's
    order (the larger position first) with their orientations, and
    ``end1_first`` whether that order puts end 1 first; ``deletion``
    marks a deletion's reads whose gap is over ``min_del_len``."""
    form: str
    names: np.ndarray
    alignments: list
    first: np.ndarray
    second: np.ndarray
    o_first: str
    o_second: str
    end1_first: bool
    deletion: Optional[np.ndarray] = None


@dataclass
class Records:
    """Every alignment: reference span [pos, end), its one-base deletions
    (``n_del`` positions ``del0 + unit * k``), one long deletion
    ``[gap0, gap0 + gap)`` (empty where ``gap`` is 0) and its read's id;
    the junctions and their reads."""
    pos: np.ndarray
    end: np.ndarray
    del0: np.ndarray
    n_del: np.ndarray
    unit: int
    name: np.ndarray
    gap0: np.ndarray
    gap: np.ndarray
    junctions: List[Junction]


def planted_records(p: dict, seed: int,
                    min_del_len: int = MIN_DEL_LEN) -> Records:
    """Every record the generator writes for mix ``p`` and ``seed``."""
    q = shape(p)
    rlen = q["read_len"]
    tiled = tiled_reads(q)
    _, dels = tiled_cigar(q)
    unit = int(dels[1] - dels[0]) if len(dels) > 1 else 1
    n_t = len(tiled)
    pos, end, del0, n_del, name, gap0, gap = \
        [tiled], [tiled + rlen], [tiled + (dels[0] if len(dels) else 0)], \
        [np.full(n_t, len(dels), np.int64)], \
        [np.arange(n_t, dtype=np.int64)], [np.zeros(n_t, np.int64)], \
        [np.zeros(n_t, np.int64)]
    junctions = []
    next_id = n_t
    seconds = []
    for jn, (j1, j2, f1) in zip(q["junctions"], junction_reads(q, seed)):
        n = len(f1)
        ids = np.arange(next_id, next_id + n, dtype=np.int64)
        next_id += n
        (p1, o1), (p2, o2) = jn["ends"]
        e1, e2 = p1 + j1, p2 + j2
        zeros = np.zeros(n, np.int64)
        if jn["form"] == "deletion":
            length = e2 - e1
            pos.append(e1 - f1)
            end.append(e2 + rlen - f1)
            del0.append(zeros)
            n_del.append(zeros)
            name.append(ids)
            gap0.append(e1)
            gap.append(length)
            alns = [((int(e1[i] - f1[i]), int(e1[i]), "+"),
                     (int(e2[i]), int(e2[i] + rlen - f1[i]), "+"))
                    for i in range(n)]
            junctions.append(Junction("deletion", ids, alns, e2, e1, "-", "+",
                                      False, length > min_del_len))
            continue
        alns = []
        for i in range(n):
            a, b = int(f1[i]), rlen - int(f1[i])
            pair = split_alignments(jn["ends"], a, b, int(j1[i]), int(j2[i]))
            alns.append(tuple((x, x + sum(ln for op, ln in cg if op == 0) - 1,
                               st) for x, st, cg in pair))
        starts = np.array([[x[0][0], x[1][0]] for x in alns], np.int64)
        stops = np.array([[x[0][1], x[1][1]] for x in alns], np.int64) + 1
        pos.append(starts[:, 0])
        end.append(stops[:, 0])
        seconds.append((starts[:, 1], stops[:, 1], ids))
        for v in (del0, n_del, gap0, gap):
            v.append(zeros)
        name.append(ids)
        if p2 < p1:
            junctions.append(Junction("split", ids, alns, e1, e2, o1, o2,
                                      True))
        else:
            junctions.append(Junction("split", ids, alns, e2, e1, o2, o1,
                                      False))
    # the split reads' second alignments follow all first ones, as records
    for st, sp, ids in seconds:
        zeros = np.zeros(len(ids), np.int64)
        pos.append(st)
        end.append(sp)
        name.append(ids)
        for v in (del0, n_del, gap0, gap):
            v.append(zeros)
    for sp in q["spanning_reads"]:
        x = np.asarray(sp["starts"], np.int64)
        _, sdels = tiled_cigar(q, sp["len"])
        ids = np.arange(next_id, next_id + len(x), dtype=np.int64)
        next_id += len(x)
        pos.append(x)
        end.append(x + sp["len"])
        del0.append(x + (sdels[0] if len(sdels) else 0))
        n_del.append(np.full(len(x), len(sdels), np.int64))
        name.append(ids)
        gap0.append(np.zeros(len(x), np.int64))
        gap.append(np.zeros(len(x), np.int64))
    cat = np.concatenate
    return Records(cat(pos), cat(end), cat(del0), cat(n_del), unit,
                   cat(name), cat(gap0), cat(gap), junctions)


def overlapping(r: Records, start: int, stop: int) -> np.ndarray:
    """Mask of alignments whose span overlaps [start, stop)."""
    return (r.pos < stop) & (r.end > start)


def _ceil_div(x, d):
    return -((-x) // d)


def aligned_bases(r: Records, start: int, stop: int) -> int:
    """Aligned bases of all alignments inside [start, stop): each span's
    overlap less the deletions that fall in it."""
    lo = np.maximum(r.pos, start)
    hi = np.minimum(r.end, stop)
    span = np.clip(hi - lo, 0, None)
    k_lo = np.clip(_ceil_div(lo - r.del0, r.unit), 0, r.n_del)
    k_hi = np.clip(_ceil_div(hi - r.del0, r.unit), 0, r.n_del)
    dels = np.where(span > 0, np.clip(k_hi - k_lo, 0, None), 0)
    long_del = np.where(r.gap > 0, np.clip(
        np.minimum(hi, r.gap0 + r.gap) - np.maximum(lo, r.gap0), 0, None), 0)
    return int(span.sum() - dels.sum() - long_del.sum())


def read_cn_file(path: str) -> List[Tuple[str, int, int, float]]:
    """(chrom, start, end, log2) rows of a CNVkit ``.cns`` file."""
    rows = []
    with open(path) as fh:
        next(fh)
        for line in fh:
            t = line.rstrip("\n").split("\t")
            rows.append((t[0], int(t[1]), int(t[2]), float(t[4])))
    return rows


def read_seeds(path: str) -> List[Tuple[str, int, int]]:
    with open(path) as fh:
        return [(t[0], int(t[1]), int(t[2])) for t in
                (line.split() for line in fh if line.strip())]


def diploid_coverage(rows, r: Records) -> float:
    """Aligned bases over the segments nearest the median log2, taken in
    pairs until they span 10 Mb, over their length."""
    log2 = [row[3] for row in rows]
    order = np.argsort(log2)
    im = int(len(order) / 2.4)
    ip = im + 1
    chosen = [rows[order[i]] for i in (ip, im) if i < len(order)]
    total = sum(row[2] - row[1] for row in chosen)
    i = 1
    while total < 10_000_000 and im - i >= 0 and ip + i < len(order):
        for k in (order[ip + i], order[im - i]):
            chosen.append(rows[k])
            total += rows[k][2] - rows[k][1]
        i += 1
    bases = sum(aligned_bases(r, row[1], row[2]) for row in chosen)
    return bases * 1.0 / total


def amplicon_interval(rows, seed_row, delta: int) -> Tuple[int, int]:
    """[left, right] (inclusive): the CN segments holding the seed's ends,
    widened by ``delta`` on each side that stays inside the table."""
    chrom = seed_row[0]
    own = [(s, e - 1) for c, s, e, _ in rows if c == chrom]

    def row_of(x):
        return next((k for k, (s, e) in enumerate(own) if s <= x <= e), None)

    left = own[row_of(seed_row[1])][0]
    right = own[row_of(seed_row[2])][1]
    if row_of(left - delta) is not None:
        left -= delta
    if row_of(right + delta) is not None:
        right += delta
    return left, right


def consensus_end(vals: np.ndarray, strand: str) -> int:
    """One end of CoRAL's consensus: the mode where it is unique, else the
    median, rounded up on '+' and down on '-' for an even count."""
    uniq, counts = np.unique(vals, return_counts=True)
    top = counts.max()
    if (counts == top).sum() == 1:
        return int(uniq[np.argmax(counts)])
    med = float(np.median(vals))
    if len(vals) % 2 == 1:
        return int(med)
    return int(math.ceil(med)) if strand == "+" else int(math.floor(med))


def consensus_breakpoint(first: np.ndarray, second: np.ndarray,
                         distance_cutoff: int,
                         strands: Tuple[str, str] = ("+", "-")
                         ) -> Tuple[int, int]:
    """The two ends of one junction's breakpoint, given each read's ends in
    CoRAL's order and their ``strands``: the members within three
    deviations of the mean on both ends, then each end's consensus."""
    n = len(first)
    keep = np.ones(n, bool)
    floor = distance_cutoff / 2.99
    for v in (first, second):
        ints = [int(x) for x in v]
        mean = sum(ints) / n
        second_moment = sum(x * x for x in ints) / n
        sd = max(floor, math.sqrt(second_moment - mean * mean)) \
            if second_moment >= mean * mean else floor
        keep &= (v <= mean + 3 * sd) & (v >= mean - 3 * sd)
    return (consensus_end(first[keep], strands[0]),
            consensus_end(second[keep], strands[1]))


@dataclass
class Breakpoint:
    """A discordant edge: its ends in CoRAL's order, its reads' ids and the
    junction they were planted on."""
    p1: int
    o1: str
    p2: int
    o2: str
    names: np.ndarray
    junction: Junction


def breakpoints(r: Records, distance_cutoff: int,
                min_reads: float = 0) -> List[Breakpoint]:
    """Each junction's breakpoint, in CoRAL's order of its ends, sorted;
    a deletion's reads count where their gap is over ``min_del_len``, and
    a junction of fewer than ``min_reads`` reads has none (``:299-388``)."""
    out = []
    for j in r.junctions:
        use = j.deletion if j.deletion is not None \
            else np.ones(len(j.names), bool)
        if not use.any() or use.sum() < min_reads:
            continue
        c1, c2 = consensus_breakpoint(j.first[use], j.second[use],
                                      distance_cutoff, (j.o_first, j.o_second))
        out.append(Breakpoint(c1, j.o_first, c2, j.o_second, j.names[use], j))
    return sorted(out, key=lambda bp: (bp.p1, bp.o1, bp.p2, bp.o2))


@dataclass
class Edge:
    kind: str                  # sequence | concordant | discordant
    ends: Tuple                # sequence: (start, end); others: (p1, o1, p2, o2)
    lr_count: int
    lr_nc: int = 0             # sequence edges: aligned bases

    @property
    def size(self) -> int:
        return self.ends[1] - self.ends[0] + 1


def amplicon_edges(r: Records, left: int, right: int,
                   bps: List[Breakpoint], match_cutoff: int) -> List[Edge]:
    """The amplicon's edges for an interval [left, right] (inclusive) and
    its breakpoints: sequence edges split at every end inside the interval,
    in order, a concordant edge at each split, then the discordant edges."""
    cuts = sorted({p if o == "+" else p - 1 for bp in bps
                   for p, o in ((bp.p1, bp.o1), (bp.p2, bp.o2))
                   if left < p < right})
    edges = []
    for s, e in zip([left] + [c + 1 for c in cuts], cuts + [right]):
        edges.append(Edge("sequence", (s, e),
                          int(overlapping(r, s, e + 1).sum()),
                          aligned_bases(r, s, e + 1)))
    for p1 in cuts:
        p2 = p1 + 1
        sets = [r.name[overlapping(r, q, q + 1)] for q in
                (p1, p2, p1 - match_cutoff - 1, p2 + match_cutoff)]
        through = sets[0]
        for s in sets[1:]:
            through = np.intersect1d(through, s)
        for bp in bps:
            if {(p1, "+"), (p2, "-")} & {(bp.p1, bp.o1), (bp.p2, bp.o2)}:
                through = np.setdiff1d(through, bp.names)
        edges.append(Edge("concordant", (p1, "+", p2, "-"), int(through.size)))
    for bp in bps:
        edges.append(Edge("discordant", (bp.p1, bp.o1, bp.p2, bp.o2),
                          int(bp.names.size)))
    return edges


def balance_matrix(edges: List[Edge], left: int, right: int) -> np.ndarray:
    """Flow balance at every node but the interval's two ends: the
    sequence edge's CN equals the sum over the breakpoint edges there."""
    nodes: Dict[Tuple[int, str], int] = {}
    rows: List[Dict[int, float]] = []

    def row(node):
        if node not in nodes:
            nodes[node] = len(rows)
            rows.append({})
        return rows[nodes[node]]

    for i, e in enumerate(edges):
        if e.kind == "sequence":
            for node in ((e.ends[0], "-"), (e.ends[1], "+")):
                if node not in ((left, "-"), (right, "+")):
                    row(node)[i] = row(node).get(i, 0.0) + 1.0
        else:
            for node in ((e.ends[0], e.ends[1]), (e.ends[2], e.ends[3])):
                row(node)[i] = row(node).get(i, 0.0) - 1.0
    A = np.zeros((len(rows), len(edges)))
    for k, rw in enumerate(rows):
        for i, v in rw.items():
            A[k, i] = v
    return A


def solve_balance(w, c, lg, A, penalty: float, dtype=np.float64) -> np.ndarray:
    """argmin sum w/x + c x - lg log x + |A x|^2 / (2 penalty), x > 0, by
    Newton steps on its KKT form ``[H A^T; A -penalty I]`` (nu = A x /
    penalty) from x = 1 (Boyd and Vandenberghe 10.3), every operation in
    ``dtype``, until the residual stops falling."""
    w, c, lg, A = (np.asarray(v, dtype) for v in (w, c, lg, A))
    pen = dtype(penalty)
    n, m = A.shape[1], A.shape[0]
    x = np.ones(n, dtype)
    nu = np.zeros(m, dtype)

    def resid(x, nu):
        g = c - lg / x - w / (x * x)
        return np.concatenate([g + A.T @ nu, A @ x - pen * nu])

    r = np.linalg.norm(resid(x, nu))
    stalls = 0
    for _ in range(200):
        h = lg / (x * x) + dtype(2) * w / (x * x * x)
        K = np.zeros((n + m, n + m), dtype)
        K[:n, :n] = np.diag(h)
        K[:n, n:] = A.T
        K[n:, :n] = A
        K[n:, n:] = -pen * np.eye(m, dtype=dtype)
        step = np.linalg.solve(K, -resid(x, nu))
        dx, dnu = step[:n], step[n:]
        t = dtype(1)
        while t > 1e-12:
            xt = x + t * dx
            if xt.min() > 0:
                rt = np.linalg.norm(resid(xt, nu + t * dnu))
                if rt <= (1 - 0.01 * t) * r:
                    break
            t = dtype(t / 2)
        if t <= 1e-12:
            # no step lowers the residual: converged to this dtype
            stalls += 1
            if stalls > 1:
                break
            continue
        x, nu, r = xt, nu + t * dnu, rt
    return x


def amplicon_cn(edges: List[Edge], normal_cov: float, left: int, right: int,
                penalty: float, dtype=np.float64) -> np.ndarray:
    """CN of each edge (twice the balance program's solution)."""
    w = [0.5 * e.lr_nc ** 2 / (normal_cov * e.size) if e.kind == "sequence"
         else 0.0 for e in edges]
    c = [0.5 * normal_cov * e.size if e.kind == "sequence" else normal_cov
         for e in edges]
    lg = [-0.5 if e.kind == "sequence" else float(e.lr_count) for e in edges]
    x = solve_balance(w, c, lg, balance_matrix(edges, left, right), penalty,
                      dtype)
    return np.asarray(x, np.float64) * 2.0


def graph_lines(chrom: str, edges: List[Edge], cn) -> List[list]:
    """The graph file's rows as fields, CN as floats."""
    out = [["SequenceEdge: StartPosition, EndPosition, PredictedCN, "
            "AverageCoverage, Size, NumberOfLongReads"]]
    for e, v in zip(edges, cn):
        if e.kind == "sequence":
            out.append(["sequence", f"{chrom}:{e.ends[0]}-",
                        f"{chrom}:{e.ends[1]}+", float(v),
                        "%f" % (e.lr_nc * 1.0 / e.size), str(e.size),
                        str(e.lr_count)])
    out.append(["BreakpointEdge: StartPosition->EndPosition, PredictedCN, "
                "NumberOfLongReads"])
    for kind in ("concordant", "discordant"):
        for e, v in zip(edges, cn):
            if e.kind == kind:
                p1, o1, p2, o2 = e.ends
                out.append([kind, f"{chrom}:{p1}{o1}->{chrom}:{p2}{o2}",
                            float(v), str(e.lr_count)])
    return out


def cycles_lines(chrom: str, edges: List[Edge], cn,
                 p_total_weight: float) -> List[list]:
    """The cycles file's rows: the interval, its three segments, no path
    constraint, the planted circle through segment 2 with the junction's
    copy number and, where that circle carries less than ``p_total_weight``
    of the amplicon's CN-weighted length, the chromosome's own path through
    all three segments with the CN of the breakpoint edges beside it."""
    seq = [(e, v) for e, v in zip(edges, cn) if e.kind == "sequence"]
    (left, _), (a, b), (_, right) = (e.ends for e, _ in seq)
    kind = [e.kind for e in edges]
    circle = float(cn[kind.index("discordant")])
    rows = [["Interval", "1", chrom, str(left), str(right)],
            ["List of cycle segments"]]
    for i, (e, _) in enumerate(seq):
        rows.append(["Segment", str(i + 1), chrom, str(e.ends[0]),
                     str(e.ends[1])])
    rows += [["List of longest subpath constraints"],
             ["Cycle=1", circle, "Segments=2+", "Path_constraints_satisfied="]]
    total = sum(float(v) * e.size for e, v in seq)
    if circle * seq[1][0].size < p_total_weight * total:
        rows.append(["Cycle=2", float(cn[kind.index("concordant")]),
                     "Segments=0+,1+,2+,3+,0-", "Path_constraints_satisfied="])
    return rows


# -- walks: path constraints and the decomposition ---------------------------

FLIP = {"+": "-", "-": "+"}


class Walks:
    """The amplicon's graph as walks see it: a walk is a list of sequence
    edges, each (its rank among the sequence edges, ``+`` or ``-`` as it is
    traversed), and between two of them the breakpoint edge that joins the
    node it leaves by to the node it enters by."""

    def __init__(self, edges: List[Edge], min_overlap: int = MIN_OVERLAP):
        self.edges = edges
        self.min_overlap = min_overlap
        self.seq = [i for i, e in enumerate(edges) if e.kind == "sequence"]
        self.starts = np.array([edges[i].ends[0] for i in self.seq], np.int64)
        self.stops = np.array([edges[i].ends[1] for i in self.seq], np.int64)
        self.links: Dict[frozenset, int] = {}
        for i, e in enumerate(edges):
            if e.kind != "sequence":
                key = frozenset([(e.ends[0], e.ends[1]),
                                 (e.ends[2], e.ends[3])])
                if e.kind == "concordant" or key not in self.links:
                    self.links[key] = i

    def exit_node(self, k: int, d: str):
        return (int(self.stops[k]), "+") if d == "+" \
            else (int(self.starts[k]), "-")

    def entry_node(self, k: int, d: str):
        return (int(self.starts[k]), "-") if d == "+" \
            else (int(self.stops[k]), "+")

    def link(self, a, b) -> Optional[int]:
        """The breakpoint edge from walk step ``a`` into step ``b``."""
        return self.links.get(frozenset([self.exit_node(*a),
                                         self.entry_node(*b)]))

    def edge_counts(self, tokens, cyclic: bool) -> Optional[Counter]:
        """Every edge the walk passes and how often; None where two steps
        have no edge between them."""
        out = Counter(self.seq[k] for k, _ in tokens)
        pairs = list(zip(tokens, tokens[1:]))
        if cyclic:
            pairs.append((tokens[-1], tokens[0]))
        for a, b in pairs:
            i = self.link(a, b)
            if i is None:
                return None
            out[i] += 1
        return out

    def seq_length(self, tokens) -> int:
        return int(sum(self.stops[k] - self.starts[k] + 1 for k, _ in tokens))

    # the walks of single reads (path_constraints.py:48-301)
    def _overlap(self, k, x0, x1) -> int:
        return int(min(self.stops[k], x1) - max(self.starts[k], x0))

    def _size(self, k) -> int:
        return int(self.stops[k] - self.starts[k] + 1)

    def flank(self, x0: int, x1: int, strand: str, node, into: bool):
        """The steps of one alignment [x0, x1] of a junction read, on
        ``strand``: ``into`` the junction at ``node`` (the read's first
        alignment) or out of it (its second)."""
        mo = self.min_overlap
        ks = [k for k in range(len(self.seq))
              if self.starts[k] <= x1 and x0 <= self.stops[k]]
        ks.sort(key=lambda k: self.starts[k], reverse=strand == "-")
        if into:
            if len(ks) > 1 and self._overlap(ks[0], x0, x1) < mo:
                del ks[0]
            while ks and self._size(ks[0]) < mo:
                del ks[0]
            while ks and self.exit_node(ks[-1], strand) != node:
                del ks[-1]
        else:
            if ks and self._overlap(ks[-1], x0, x1) < mo:
                del ks[-1]
            while ks and self._size(ks[-1]) < mo:
                del ks[-1]
            while ks and self.entry_node(ks[0], strand) != node:
                del ks[0]
        return [(k, strand) for k in ks]

    def read_walk(self, x0: int, x1: int):
        """The steps of a read aligned once over [x0, x1]: the sequence
        edges it overlaps, less an end edge overlapped by under
        ``min_overlap`` or shorter than that; none below three."""
        mo = self.min_overlap
        k0 = int(np.searchsorted(self.stops, x0, "left"))
        k1 = int(np.searchsorted(self.starts, x1, "right")) - 1
        ks = list(range(k0, k1 + 1))
        if len(ks) < 3:
            return []
        if len(ks) > 1 and self._overlap(ks[0], x0, x1) < mo:
            del ks[0]
        while len(ks) > 1 and self._size(ks[0]) < mo:
            del ks[0]
        if len(ks) > 1 and self._overlap(ks[-1], x0, x1) < mo:
            del ks[-1]
        while len(ks) > 1 and self._size(ks[-1]) < mo:
            del ks[-1]
        return [(k, "+") for k in ks] if len(ks) > 2 else []


def reverse_walk(tokens):
    return [(k, FLIP[d]) for k, d in reversed(tokens)]


def walk_text(tokens) -> str:
    """A walk as the cycles file writes a path constraint (1-based, turned
    so that it starts at its lower sequence edge)."""
    if tokens[0][0] > tokens[-1][0]:
        tokens = reverse_walk(tokens)
    return ",".join(f"{k + 1}{d}" for k, d in tokens)


def path_constraints(w: Walks, r: Records, bps: List[Breakpoint],
                     left: int) -> List[list]:
    """[walk, support] of the longest path constraints: each junction
    read's walk through its breakpoint (two or more edges on its two sides
    together), then each read that no junction holds, aligned once and
    passing a concordant edge's node, over the edges it overlaps; a walk
    and its reversal count as one; a walk another one contains is dropped
    and lends that one its support where it is larger."""
    found: List[list] = []
    index: Dict[tuple, int] = {}

    def record(tokens):
        if len(tokens) < 3:
            return
        key = tuple(tokens)
        i = index.get(key, index.get(tuple(reverse_walk(tokens))))
        if i is None:
            index[key] = len(found)
            found.append([tokens, 1])
        else:
            found[i][1] += 1

    held = set()
    for bp in bps:
        j = bp.junction
        held.update(int(x) for x in j.names)
        ends = [(bp.p1, bp.o1), (bp.p2, bp.o2)]
        n1, n2 = ends if j.end1_first else ends[::-1]
        use = j.deletion if j.deletion is not None \
            else np.ones(len(j.names), bool)
        for (a, b), ok in zip(j.alignments, use):
            if not ok:
                continue
            left_part = w.flank(min(a[:2]), max(a[:2]), a[2], n1, True)
            right_part = w.flank(min(b[:2]), max(b[:2]), b[2], n2, False)
            if left_part and right_part:
                record(left_part + right_part)
    for j in r.junctions:
        use = j.deletion if j.deletion is not None \
            else np.ones(len(j.names), bool)
        held.update(int(x) for x in j.names[use])
    near = np.zeros(len(r.pos), bool)
    for e in w.edges:
        if e.kind == "concordant":
            for q in (e.ends[0], e.ends[2]):
                near |= overlapping(r, q, q + 1)
    names = set(int(x) for x in r.name[near]) - held
    at = np.flatnonzero(near & (r.end > left))
    for i in at[np.argsort(r.pos[at], kind="stable")]:
        if int(r.name[i]) in names:
            record(w.read_walk(int(r.pos[i]), int(r.end[i])))

    counts = [w.edge_counts(t, False) for t, _ in found]
    keep = list(range(len(found)))
    support = [n for _, n in found]
    for i in range(len(found) - 1, -1, -1):
        for j in keep:
            if j != i and all(counts[j][e] >= c for e, c in counts[i].items()):
                keep.remove(i)
                support[j] = max(support[j], support[i])
                break
    return [[found[i][0], support[i]] for i in keep]


def chromosome_walk(w: Walks):
    """The reference genome's own walk through every sequence edge."""
    return [(k, "+") for k in range(len(w.seq))]


def max_cover(lengths, counts: List[Counter], cap: Dict[int, float]):
    """Copy counts of the walks that cover the most CN-weighted length
    (``lengths`` a unit of each walk) while no edge carries more than its
    CN: the best vertex of {w >= 0, sum_i w_i counts_i(e) <= cap(e)}."""
    k = len(lengths)
    keys = sorted({e for c in counts for e in c})
    rows = [[float(c.get(e, 0)) for c in counts] for e in keys]
    rows += [[-1.0 if i == j else 0.0 for j in range(k)] for i in range(k)]
    A = np.array(rows)
    b = np.array([cap[e] for e in keys] + [0.0] * k)
    best, best_w = -1.0, np.zeros(k)
    for pick in itertools.combinations(range(len(A)), k):
        M = A[list(pick)]
        if abs(np.linalg.det(M)) < 1e-9:
            continue
        x = np.linalg.solve(M, b[list(pick)])
        if np.all(A @ x <= b + 1e-12 * np.maximum(1.0, np.abs(b))):
            cover = float(np.dot(lengths, x))
            if cover > best:
                best, best_w = cover, x
    return np.maximum(best_w, 0.0)


@dataclass
class Decomposition:
    """The reference's walks (cycles then paths, each as steps, a cycle or
    not, its copy count and its edges), its path constraints ([steps,
    support, met]) and the CN-weighted length the walks cover."""
    walks: List[tuple]
    constraints: List[list]
    coverage: float


def decompose(w: Walks, cn, circles: List[list], constraints: List[list],
              p_total_weight: float) -> Decomposition:
    """The listed circles, and the chromosome's walk where they cover under
    ``p_total_weight`` of the CN-weighted length or leave a path
    constraint unmet, at the copy counts of :func:`max_cover`."""
    cap = {i: float(v) for i, v in enumerate(cn)}
    total = sum(float(cn[i]) * w.edges[i].size for i in w.seq)
    walks = []
    for c in circles:
        counts = w.edge_counts(c, True)
        if counts is None:
            raise ValueError(f"circle {walk_text(c)} is no walk of the graph")
        walks.append((c, True, counts))
    pcs = [w.edge_counts(t, False) for t, _ in constraints]

    def met(walk_counts):
        return [any(all(c[e] >= n for e, n in pc.items()) for c in walk_counts)
                for pc in pcs]

    def lengths(ws):
        return [sum(w.edges[e].size * n for e, n in c.items()
                    if w.edges[e].kind == "sequence") for _, _, c in ws]

    x = max_cover(lengths(walks), [c for _, _, c in walks], cap) \
        if walks else np.zeros(0)
    cover = float(np.dot(lengths(walks), x)) if walks else 0.0
    if cover < p_total_weight * total or \
            not all(met([c for _, _, c in walks])):
        path = chromosome_walk(w)
        walks.append((path, False, w.edge_counts(path, False)))
        x = max_cover(lengths(walks), [c for _, _, c in walks], cap)
        cover = float(np.dot(lengths(walks), x))
    flags = met([c for (_, _, c), v in zip(walks, x) if v > 0])
    return Decomposition(
        [(t, cyc, float(v), c) for (t, cyc, c), v in zip(walks, x)],
        [[t, n, ok] for (t, n), ok in zip(constraints, flags)], cover)


def walks_lines(chrom: str, w: Walks, left: int, right: int,
                dec: Decomposition) -> List[list]:
    """The cycles file's rows of a decomposition: the interval, the
    segments, the path constraints with their support and whether a walk
    meets them, then the walks by copy count, highest first, each listing
    the constraints it is the first walk to meet."""
    rows = [["Interval", "1", chrom, str(left), str(right)],
            ["List of cycle segments"]]
    for k in range(len(w.seq)):
        rows.append(["Segment", str(k + 1), chrom, str(int(w.starts[k])),
                     str(int(w.stops[k]))])
    rows.append(["List of longest subpath constraints"])
    for i, (t, n, ok) in enumerate(dec.constraints):
        rows.append(["Path constraint", str(i + 1), walk_text(t),
                     f"Support={n}", "Satisfied" if ok else "Unsatisfied"])
    owner: Dict[int, int] = {}
    for wi, (_, _, _, c) in enumerate(dec.walks):
        for i, (t, _, _) in enumerate(dec.constraints):
            pc = w.edge_counts(t, False)
            if i not in owner and all(c[e] >= n for e, n in pc.items()):
                owner[i] = wi
    order = sorted(range(len(dec.walks)), key=lambda i: -dec.walks[i][2])
    for rank, wi in enumerate(order):
        t, cyc, copy, _ = dec.walks[wi]
        segs = ",".join(f"{k + 1}{d}" for k, d in t)
        if not cyc:
            segs = f"0+,{segs},0-"
        rows.append([f"Cycle={rank + 1}", copy, f"Segments={segs}",
                     "Path_constraints_satisfied=" + ",".join(
                         str(i + 1) for i in sorted(owner)
                         if owner[i] == wi)])
    return rows
