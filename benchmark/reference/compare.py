"""The comparison that decides ``correct``.

A sample's outputs are each amplicon's graph file, its cycles file (when
the configuration decomposes cycles) and the CN of each edge at full
precision as the program's graphs hold it after the call.  They are held
against what :mod:`model` works out from the planted sample, field by field:

``mismatches``   every field but the CN of every row of both files, exact:
                 the breakpoint and the interval's ends in every edge's
                 positions, sizes, read counts, aligned-base coverage, the
                 interval, the segments, the path constraints, the cycle's
                 segments; a row or an amplicon that is missing or extra
                 counts each of its fields.  Also counts a printed CN that
                 does not round the graph's own value.  Limit 0.
``cn_rel_gap``   the largest relative gap between an edge's CN and the
                 reference's float64 CN.
``copy_rel_gap`` the same for each cycle's copy count.
"""
from __future__ import annotations

import math
import os
import sys
from typing import Dict, List, Optional

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import model  # noqa: E402

KINDS = ("sequence", "concordant", "discordant")


class Reference:
    """The reference for one sample: its planted records, CN segments, seed
    interval and the configuration's constants; each amplicon's edges are
    worked out once, its CN once per dtype."""

    def __init__(self, mix: dict, seed: int, cns_path: str, seeds_path: str,
                 constants: dict):
        self.mix = mix
        self.constants = constants
        r = model.planted_records(mix, seed)
        rows = model.read_cn_file(cns_path)
        self.normal_cov = model.diploid_coverage(rows, r)
        self.amplicons = []
        for seed_row in model.read_seeds(seeds_path):
            left, right = model.amplicon_interval(
                rows, seed_row, constants["interval_delta"])
            b, a = model.consensus_breakpoint(
                r.b, r.a, constants["min_bp_match_cutoff"])
            edges = model.amplicon_edges(r, left, right, a, b,
                                         constants["min_bp_match_cutoff"])
            self.amplicons.append((seed_row[0], left, right, edges))
        self._cn = {}

    def cn(self, k: int, dtype=np.float64) -> np.ndarray:
        key = (k, np.dtype(dtype).name)
        if key not in self._cn:
            _, left, right, edges = self.amplicons[k]
            self._cn[key] = model.amplicon_cn(
                edges, self.normal_cov, left, right,
                self.constants["cn_balance_penalty"], dtype)
        return self._cn[key]

    def lines(self, k: int, with_cycles: bool, dtype=np.float64):
        """(graph rows, cycles rows or None) of amplicon ``k``."""
        chrom, _, _, edges = self.amplicons[k]
        cn = self.cn(k, dtype)
        cyc = (model.cycles_lines(chrom, edges, cn,
                                  self.constants["p_total_weight"])
               if with_cycles else None)
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
        _compare_rows(_rows(out["graph"]), graph, state, cn_full)
        if with_cycles:
            _compare_rows(_rows(out.get("cycles")), cycles, state, copy=True)


def new_state(with_cycles: bool) -> dict:
    s = {"mismatches": 0, "cn_rel_gap": 0.0}
    if with_cycles:
        s["copy_rel_gap"] = 0.0
    return s


def merge(total: dict, one: dict) -> None:
    """Fold one sample's numbers into the run's: counts add, gaps take the
    largest."""
    for k, v in one.items():
        total[k] = total[k] + v if k == "mismatches" else max(total[k], v)


def verdict(state: dict, limits: dict) -> bool:
    """Every number within its limit (a number above or not finite fails)."""
    return all(state[k] <= limits[k] for k in state)


def control_outputs(ref: Reference, with_cycles: bool,
                    dtype=np.float32) -> List[dict]:
    """The reference put in the program's place in a lower precision: each
    amplicon's files and full-precision CN as the reference writes them
    when its CN balance runs in ``dtype``."""
    res = []
    for k, (_, _, _, edges) in enumerate(ref.amplicons):
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
    return {k: {"value": state[k], "limit": limits[k]} for k in state}
