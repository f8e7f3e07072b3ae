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
  (``:213-240``); the planted junction's alignments all lie inside one CN
  segment, so no breakpoint search extends it;
* the junction's breakpoint: CoRAL's consensus over every junction read
  (``:299-388``): members within three deviations of the mean (at least
  ``distance_cutoff / 2.99``), then each end's mode where it is unique, else
  the median rounded by the read count's parity and the end's strand;
* each amplicon's graph: three sequence edges split at the breakpoint, two
  concordant edges, one discordant edge, with every read count and
  aligned-base total (``assign_cov``, ``:1019-1056``);
* the CN balance (``breakpoint_graph.py:495-606``): the convex program
  ``min sum w_i/x_i + c_i x_i - l_i log x_i`` with flow balance ``A x = 0``
  at every inner node, as the program poses it (``graph/cn_solver.py``: a
  KKT system whose constraint block carries ``-penalty * I``, so that its
  solution is that of the balance held by the quadratic penalty
  ``|A x|^2 / (2 penalty)``), solved here by Newton steps on that system
  to the precision of the dtype given;
* the cycle decomposition: the planted circle, the junction's segment at
  the junction's copy number, and the chromosome's path where the circle
  leaves more than ``1 - p_total_weight`` of the CN-weighted length.

Imports nothing of the program.
"""
from __future__ import annotations

import math
import os
import sys
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "traffic"))
from generator import junction_reads, tiled_cigar, tiled_reads  # noqa: E402


@dataclass
class Records:
    """Every alignment: reference span [pos, end), its deletions (``n_del``
    positions ``del0 + unit * k``) and its read's id; the junction reads'
    ids and their breakpoint ends ``b`` (last base of the primary) and
    ``a`` (first base of the supplementary)."""
    pos: np.ndarray
    end: np.ndarray
    del0: np.ndarray
    n_del: np.ndarray
    unit: int
    name: np.ndarray
    junction_names: np.ndarray
    b: np.ndarray
    a: np.ndarray


def planted_records(p: dict, seed: int) -> Records:
    """Every record the generator writes for mix ``p`` and ``seed``."""
    rlen = p["read_len"]
    tiled = tiled_reads(p)
    _, dels = tiled_cigar(p)
    j1, j2, f1 = junction_reads(p, seed)
    a0, a1 = p["amp"]
    p1 = a1 - f1 + j1
    p2 = a0 + j2
    n_t, n_j = len(tiled), len(f1)
    jx = np.arange(n_t, n_t + n_j, dtype=np.int64)
    zeros = np.zeros(2 * n_j, np.int64)
    unit = int(dels[1] - dels[0]) if len(dels) > 1 else 1
    return Records(
        pos=np.concatenate([tiled, p1, p2]),
        end=np.concatenate([tiled + rlen, p1 + f1, p2 + rlen - f1]),
        del0=np.concatenate([tiled + (dels[0] if len(dels) else 0), zeros]),
        n_del=np.concatenate([np.full(n_t, len(dels), np.int64), zeros]),
        unit=unit,
        name=np.concatenate([np.arange(n_t, dtype=np.int64), jx, jx]),
        junction_names=jx, b=p1 + f1 - 1, a=p2)


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
    return int(span.sum() - dels.sum())


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


def consensus_breakpoint(b: np.ndarray, a: np.ndarray,
                         distance_cutoff: int) -> Tuple[int, int]:
    """(b, a) of the junction ``b``+ -> ``a``-: the members within three
    deviations of the mean on both ends, then each end's consensus."""
    n = len(b)
    keep = np.ones(n, bool)
    floor = distance_cutoff / 2.99
    for v in (b, a):
        ints = [int(x) for x in v]
        mean = sum(ints) / n
        second = sum(x * x for x in ints) / n
        sd = max(floor, math.sqrt(second - mean * mean)) \
            if second >= mean * mean else floor
        keep &= (v <= mean + 3 * sd) & (v >= mean - 3 * sd)
    return consensus_end(b[keep], "+"), consensus_end(a[keep], "-")


@dataclass
class Edge:
    kind: str                  # sequence | concordant | discordant
    ends: Tuple                # sequence: (start, end); others: (p1, o1, p2, o2)
    lr_count: int
    lr_nc: int = 0             # sequence edges: aligned bases

    @property
    def size(self) -> int:
        return self.ends[1] - self.ends[0] + 1


def amplicon_edges(r: Records, left: int, right: int, a: int, b: int,
                   match_cutoff: int) -> List[Edge]:
    """The planted amplicon's edges for an interval [left, right] and a
    junction from ``b``+ back to ``a``-."""
    edges = []
    for s, e in ((left, a - 1), (a, b), (b + 1, right)):
        edges.append(Edge("sequence", (s, e),
                          int(overlapping(r, s, e + 1).sum()),
                          aligned_bases(r, s, e + 1)))
    jx = r.junction_names
    for p1, p2 in ((a - 1, a), (b, b + 1)):
        sets = [r.name[overlapping(r, q, q + 1)] for q in
                (p1, p2, p1 - match_cutoff - 1, p2 + match_cutoff)]
        through = sets[0]
        for s in sets[1:]:
            through = np.intersect1d(through, s)
        through = np.setdiff1d(through, jx)
        edges.append(Edge("concordant", (p1, "+", p2, "-"), int(through.size)))
    edges.append(Edge("discordant", (b, "+", a, "-"), int(jx.size)))
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
