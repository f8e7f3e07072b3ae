"""The comparison that decides ``correct``.

A sample's outputs are each amplicon's graph file, its cycles file (when
the configuration decomposes cycles) and the CN of each edge at full
precision as the program's graphs hold it after the call.  They are held
against what :mod:`model` works out from the planted sample, field by field:

``mismatches``   every field but the CN of every row of both files, exact:
                 the breakpoints and the interval's ends in every edge's
                 positions, sizes, read counts, aligned-base coverage, the
                 interval, the segments, the path constraints, the cycles'
                 segments; a row or an amplicon that is missing or extra
                 counts each of its fields.  Also counts a printed CN that
                 does not round the graph's own value.  Limit 0.
``cn_rel_gap``   the largest relative gap between an edge's CN and the
                 reference's float64 CN.
``copy_rel_gap`` the same for each cycle's copy count (a one-segment
                 circle).

An amplicon of more than one junction has more than one walk, and CoRAL's
model does not fix their copy counts (``docs/GBM39_PARITY.md``).  Its
discordant edges are compared in the order of their ends, and its cycles
file by what the model does fix: ``mismatches`` also counts a path
constraint row (walk, ``Support=``, ``Satisfied``) that one side has and
the other has not, each cycle and each path more or fewer than the
reference has, each listed circle missing from the cycles (compared
without rotation and reflection), each constraint that one side meets and
the other does not, and each line of no known kind; and two numbers come
in place of ``copy_rel_gap``:

``coverage_rel_gap`` the relative gap between the CN-weighted length the
                 walks cover (copy count times the length of each sequence
                 edge passed) and the reference's;
``cap_excess``   the largest relative amount by which the copy counts
                 times the passes through an edge exceed the edge's CN,
                 the reference's float64 CN (0 where none does).
"""
from __future__ import annotations

import math
import os
import re
import sys
from collections import Counter
from typing import Dict, List, Optional

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import model  # noqa: E402
from generator import shape  # noqa: E402

KINDS = ("sequence", "concordant", "discordant")


class Reference:
    """The reference for one sample: its planted records, CN segments, seed
    interval and the configuration's constants; each amplicon's edges are
    worked out once, its CN and its decomposition once per dtype.

    ``simple`` is a one-segment circle (one split junction from a last base
    back to a first), judged by :func:`model.cycles_lines`; any other
    sample is judged by its invariants."""

    def __init__(self, mix: dict, seed: int, cns_path: str, seeds_path: str,
                 constants: dict):
        self.mix = shape(mix)
        self.constants = constants
        cut = constants["min_bp_match_cutoff"]
        r = model.planted_records(
            mix, seed, constants.get("min_del_len", model.MIN_DEL_LEN))
        self.records = r
        rows = model.read_cn_file(cns_path)
        self.normal_cov = model.diploid_coverage(rows, r)
        jx = self.mix["junctions"]
        self.simple = len(jx) == 1 and jx[0]["form"] == "split" and \
            [o for _, o in jx[0]["ends"]] == ["+", "-"] and \
            jx[0]["ends"][1][0] < jx[0]["ends"][0][0]
        self.amplicons = []
        for seed_row in model.read_seeds(seeds_path):
            left, right = model.amplicon_interval(
                rows, seed_row, constants["interval_delta"])
            bps = model.breakpoints(r, cut, max(
                constants.get("min_cluster_cutoff", model.MIN_CLUSTER),
                constants.get("min_bp_support", 1.0) * self.normal_cov))
            edges = model.amplicon_edges(r, left, right, bps, cut)
            self.amplicons.append((seed_row[0], left, right, edges, bps))
        self._cn = {}
        self._walks = {}

    def cn(self, k: int, dtype=np.float64) -> np.ndarray:
        key = (k, np.dtype(dtype).name)
        if key not in self._cn:
            _, left, right, edges, _ = self.amplicons[k]
            self._cn[key] = model.amplicon_cn(
                edges, self.normal_cov, left, right,
                self.constants["cn_balance_penalty"], dtype)
        return self._cn[key]

    def walks(self, k: int):
        """(the graph's walks, the path constraints) of amplicon ``k``."""
        if k not in self._walks:
            _, left, _, edges, bps = self.amplicons[k]
            w = model.Walks(edges, self.constants.get("min_overlap",
                                                      model.MIN_OVERLAP))
            self._walks[k] = (w, model.path_constraints(w, self.records, bps,
                                                        left))
        return self._walks[k]

    def circles(self, k: int):
        """The mix's circles as walks of amplicon ``k``'s graph: each
        segment of the mix is the graph's sequence edges whose middle lies
        in it."""
        w, _ = self.walks(k)
        mid = (w.starts + w.stops) / 2
        out = []
        for text in self.mix["circles"]:
            steps = []
            for tok in text.split(","):
                s0, s1 = self.mix["segments"][int(tok[:-1]) - 1]["at"]
                ks = [int(x) for x in np.flatnonzero((mid >= s0) & (mid < s1))]
                steps += [(x, tok[-1]) for x in
                          (ks if tok[-1] == "+" else ks[::-1])]
            out.append(steps)
        return out

    def decomposition(self, k: int, dtype=np.float64) -> model.Decomposition:
        w, pcs = self.walks(k)
        return model.decompose(w, self.cn(k, dtype), self.circles(k), pcs,
                               self.constants["p_total_weight"])

    def lines(self, k: int, with_cycles: bool, dtype=np.float64):
        """(graph rows, cycles rows or None) of amplicon ``k``."""
        chrom, left, right, edges, _ = self.amplicons[k]
        cn = self.cn(k, dtype)
        cyc = None
        if with_cycles and self.simple:
            cyc = model.cycles_lines(chrom, edges, cn,
                                     self.constants["p_total_weight"])
        elif with_cycles:
            cyc = model.walks_lines(chrom, self.walks(k)[0], left, right,
                                    self.decomposition(k, dtype))
        return model.graph_lines(chrom, edges, cn), cyc


def _rows(text: Optional[str]) -> List[List[str]]:
    if text is None:
        return []
    out = []
    for line in text.splitlines():
        out.append(line.split(";") if line.startswith("Cycle=")
                   else line.split("\t"))
    return out


def _gap(x: float, ref: float) -> float:
    if not math.isfinite(x):
        return math.inf
    return abs(x - ref) / max(abs(ref), 1e-300)


def _compare_rows(got, want, state, cn_values=None, copy=False):
    """Field-by-field comparison; floats in ``want`` are the reference's CN
    (or copy count) and are compared by relative gap."""
    state["mismatches"] += sum(len(r) for r in want[len(got):])
    state["mismatches"] += sum(len(r) for r in got[len(want):])
    cn_iter = iter(cn_values or [])
    for g, w in zip(got, want):
        state["mismatches"] += abs(len(g) - len(w))
        for gf, wf in zip(g, w):
            if not isinstance(wf, float):
                state["mismatches"] += gf != wf
                continue
            key = "copy_rel_gap" if copy else "cn_rel_gap"
            try:
                printed = float(gf.split("=")[-1])
            except ValueError:
                state["mismatches"] += 1
                state[key] = math.inf
                continue
            if copy:
                state[key] = max(state[key], _gap(printed, wf))
                continue
            full = next(cn_iter, None)
            if full is None:
                state["mismatches"] += 1
                state[key] = math.inf
                continue
            if not abs(printed - full) <= 5.0001e-7 + 1e-12 * abs(full):
                state["mismatches"] += 1
            state[key] = max(state[key], _gap(full, wf))


_DISC = re.compile(r"^\S+?:(\d+)([+-])->\S+?:(\d+)([+-])$")


def _discordant_in_order(rows, cn_full):
    """The graph's rows and CN with its discordant edges sorted by their
    ends, as the reference lists them."""
    at = [i for i, r in enumerate(rows) if r and r[0] == "discordant"]
    if not at or len(cn_full) < len(at):
        return rows, cn_full

    def key(row):
        m = _DISC.match(row[1]) if len(row) > 1 else None
        return (int(m[1]), m[2], int(m[3]), m[4]) if m else (math.inf,)
    order = sorted(range(len(at)), key=lambda j: key(rows[at[j]]))
    out = list(rows)
    for slot, j in zip(at, order):
        out[slot] = rows[at[j]]
    head = len(cn_full) - len(at)
    return out, cn_full[:head] + [cn_full[head + j] for j in order]


def _canonical(steps):
    """A circle's steps without its rotation or reflection."""
    forms = []
    for seq in (list(steps), model.reverse_walk(steps)):
        forms += [tuple(seq[i:] + seq[:i]) for i in range(len(seq))]
    return min(forms)


def read_walks(rows: List[List[str]], w: model.Walks, cn) -> dict:
    """What the rows of a cycles file say of its walks, read against the
    graph ``w`` and each edge's CN ``cn``: ``circles`` (each without its
    rotation or reflection), ``paths``, ``met`` (the walk of each path
    constraint a walk lists as met, by the file's own constraint rows),
    ``coverage`` (the CN-weighted length covered), ``cap_excess`` (the
    largest relative amount by which the walks load an edge over its CN)
    and ``unread`` (rows that are no walk of the graph: they make
    ``coverage`` and ``cap_excess`` infinite)."""
    by_index = {r[1]: r[2] for r in rows
                if r[0] == "Path constraint" and len(r) == 5}
    load: Dict[int, float] = {}
    out = {"circles": [], "paths": 0, "met": set(), "coverage": 0.0,
           "unread": 0}
    for r in rows:
        if not r[0].startswith("Cycle="):
            continue
        f = dict(x.split("=", 1) for x in r if "=" in x)
        toks = [t for t in f.get("Segments", "").split(",") if t]
        is_path = len(toks) >= 2 and toks[0] == "0+" and toks[-1] == "0-"
        toks = toks[1:-1] if is_path else toks
        try:
            copy = float(f["Copy_count"])
            steps = [(int(t[:-1]) - 1, t[-1]) for t in toks]
        except (KeyError, ValueError):
            out["unread"] += 1
            continue
        counts = (w.edge_counts(steps, not is_path) if steps and all(
            0 <= x < len(w.seq) and d in "+-" for x, d in steps) else None)
        if counts is None or not math.isfinite(copy):
            out["unread"] += 1
            continue
        out["paths"] += is_path
        if not is_path:
            out["circles"].append(_canonical(steps))
        out["coverage"] += copy * w.seq_length(steps)
        for e, n in counts.items():
            load[e] = load.get(e, 0.0) + copy * n
        out["met"].update(by_index.get(x) for x in
                          f.get("Path_constraints_satisfied", "").split(",")
                          if x)
    out["cap_excess"] = max([(v - float(cn[e])) / float(cn[e])
                             for e, v in load.items()] + [0.0])
    if out["unread"]:
        out["coverage"] = out["cap_excess"] = math.inf
    return out


def _judge_walks(text: Optional[str], ref: Reference, k: int,
                 state: dict) -> None:
    """The cycles file of an amplicon of several walks, by the invariants
    of CoRAL's model (see the module's docstring)."""
    chrom, left, right, _, _ = ref.amplicons[k]
    w, _ = ref.walks(k)
    dec = ref.decomposition(k)
    want = model.walks_lines(chrom, w, left, right, dec)
    got = _rows(text)
    n_head = next(i for i, r in enumerate(want)
                  if r[0] == "Path constraint" or r[0].startswith("Cycle="))
    _compare_rows(got[:n_head], want[:n_head], state)
    got_pcs = [tuple(r[2:]) for r in got[n_head:]
               if r[0] == "Path constraint"]
    want_pcs = [tuple(r[2:]) for r in want[n_head:]
                if r[0] == "Path constraint"]
    state["mismatches"] += _multiset_gap(got_pcs, want_pcs)
    state["mismatches"] += sum(
        1 for r in got[n_head:]
        if r[0] != "Path constraint" and not r[0].startswith("Cycle="))
    seen = read_walks(got[n_head:], w, ref.cn(k))
    want_cycles = [_canonical(t) for t, cyc, _, _ in dec.walks if cyc]
    state["mismatches"] += seen["unread"]
    state["mismatches"] += abs(len(seen["circles"]) - len(want_cycles))
    state["mismatches"] += abs(seen["paths"] -
                               sum(not c for _, c, _, _ in dec.walks))
    state["mismatches"] += sum(c not in seen["circles"] for c in want_cycles)
    want_met = {model.walk_text(t) for t, _, ok in dec.constraints if ok}
    state["mismatches"] += len(seen["met"] ^ want_met)
    state["coverage_rel_gap"] = max(state["coverage_rel_gap"],
                                    _gap(seen["coverage"], dec.coverage))
    state["cap_excess"] = max(state["cap_excess"], seen["cap_excess"])


def _multiset_gap(a, b) -> int:
    """Items in one list and not the other, counted with multiplicity."""
    ca, cb = Counter(a), Counter(b)
    return sum(((ca - cb) + (cb - ca)).values())


def judge_sample(outputs: List[dict], ref: Reference, with_cycles: bool,
                 state: dict) -> None:
    """Compare one sample's outputs (one dict an amplicon, in the program's
    order: ``graph`` and ``cycles`` texts, ``cn`` lists by edge kind) with
    the reference's amplicons into ``state``."""
    for k in range(max(len(outputs), len(ref.amplicons))):
        if k >= len(outputs) or k >= len(ref.amplicons):
            # an amplicon missing or extra: its every field
            want = ref.lines(min(k, len(ref.amplicons) - 1), with_cycles)
            state["mismatches"] += sum(len(r) for part in want if part
                                       for r in part)
            continue
        out = outputs[k]
        graph, cycles = ref.lines(k, with_cycles)
        cn_full = [v for kind in KINDS for v in out["cn"].get(kind, [])]
        rows = _rows(out["graph"])
        if not ref.simple:
            rows, cn_full = _discordant_in_order(rows, cn_full)
        _compare_rows(rows, graph, state, cn_full)
        if with_cycles and ref.simple:
            _compare_rows(_rows(out.get("cycles")), cycles, state, copy=True)
        elif with_cycles:
            _judge_walks(out.get("cycles"), ref, k, state)


def new_state(with_cycles: bool, simple: bool = True) -> dict:
    """The numbers a sample is judged by: ``simple`` a one-segment circle
    (see :class:`Reference`)."""
    s = {"mismatches": 0, "cn_rel_gap": 0.0}
    if with_cycles and simple:
        s["copy_rel_gap"] = 0.0
    elif with_cycles:
        s.update(coverage_rel_gap=0.0, cap_excess=0.0)
    return s


def merge(total: dict, one: dict) -> None:
    """Fold one sample's numbers into the run's: counts add, gaps take the
    largest."""
    for k, v in one.items():
        total[k] = total[k] + v if k == "mismatches" else max(total[k], v)


def verdict(state: dict, limits: dict) -> bool:
    """Every number within its limit (a number above, not finite or with no
    limit fails)."""
    return all(k in limits and state[k] <= limits[k] for k in state)


def control_outputs(ref: Reference, with_cycles: bool,
                    dtype=np.float32) -> List[dict]:
    """The reference put in the program's place in a lower precision: each
    amplicon's files and full-precision CN as the reference writes them
    when its CN balance runs in ``dtype``."""
    res = []
    for k, (_, _, _, edges, _) in enumerate(ref.amplicons):
        cn = ref.cn(k, dtype)
        graph, cycles = ref.lines(k, with_cycles, dtype)
        text = "\n".join("\t".join("%f" % f if isinstance(f, float) else f
                                   for f in row) for row in graph) + "\n"
        item = {"graph": text,
                "cn": {kind: [float(v) for e, v in zip(edges, cn)
                              if e.kind == kind] for kind in KINDS}}
        if with_cycles:
            for r in cycles:
                if r[0].startswith("Cycle="):
                    r[1] = f"Copy_count={r[1]!r}"
            item["cycles"] = "\n".join(
                (";" if r[0].startswith("Cycle=") else "\t").join(r)
                for r in cycles) + "\n"
        res.append(item)
    return res


def summary(state: dict, limits: dict) -> Dict[str, dict]:
    """Each number beside its limit, for the result line."""
    return {k: {"value": state[k], "limit": limits.get(k)} for k in state}
