"""Amplicon visualization: breakpoint-graph and cycle plots.

Behavioral port of the reference visualizer (``src/plot_amplicons.py``):
``plot_graph`` renders CN steps on sequence edges, discordant-edge arcs
color-coded by orientation, windowed coverage bars, and a gene track;
``plot_cycles`` renders stacked cycle/path segment ladders with oriented
connectors.  Differences:

* coverage windows come from one exact per-interval profile of our BAM
  layer instead of per-window htslib pileups (same numbers, one decode);
* refGene annotation files are not shipped by the reference snapshot
  (``parse_genes`` would crash); here a missing annotation degrades to an
  empty gene track with a warning.
"""
from __future__ import annotations

import logging
import os
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import matplotlib.ticker as ticker  # noqa: E402
import numpy as np  # noqa: E402
from matplotlib import gridspec  # noqa: E402
from matplotlib.collections import LineCollection, PatchCollection  # noqa: E402
from matplotlib.patches import Arc, Rectangle  # noqa: E402

from ..constants import sort_chrom_names  # noqa: E402
from .. import cycle2bed  # noqa: E402
from ..io.bam import BamFile  # noqa: E402

logger = logging.getLogger(__name__)

matplotlib.rcParams["pdf.fonttype"] = 42

ANNOTATIONS_DIRS = [
    os.path.join(os.path.dirname(__file__), "..", "annotations_data"),
]


class GraphLayout:
    """Figure x-coordinate system for amplified intervals, computed once
    from the flat interval / sequence-edge tables (vectorized cumsum
    layout; replaces the reference's per-segment cursor walk,
    ``plot_amplicons.py:260-414``).

    Two genome->figure maps coexist, matching the reference's visual
    contract exactly:

    * **seq-cumulative** (``seq_bars``): CN bar endpoints accumulate
      per-edge lengths in edge order;
    * **interval-linear** (``pos_x``): breakpoints/coverage/genes/ticks
      map positions linearly within their interval.

    Interval k of a chromosome starts at
    ``chrom_x0 + k*margin + (sum of preceding edge lengths)*scale``; both
    maps derive from the same cumulative arrays.
    """

    def __init__(self, sorted_chrs, intervals_by_chr, seq_edges_by_chr,
                 margin, total_len):
        self.scale = 100.0 / total_len
        self.margin = margin
        self.starts: Dict[str, list] = {}
        self._iv_start: Dict[str, np.ndarray] = {}
        self._iv_end: Dict[str, np.ndarray] = {}
        # per-edge flat columns (all chroms, edge order)
        bar_chrom: List[str] = []
        bar_x1: List[np.ndarray] = []
        bar_x2: List[np.ndarray] = []
        bar_cn: List[np.ndarray] = []
        bar_s: List[np.ndarray] = []
        bar_e: List[np.ndarray] = []
        x0 = float(margin)
        for chrom in sorted_chrs:
            ivs = np.asarray([iv[0] for iv in intervals_by_chr[chrom]])
            ive = np.asarray([iv[1] for iv in intervals_by_chr[chrom]])
            self._iv_start[chrom] = ivs
            self._iv_end[chrom] = ive
            edges = seq_edges_by_chr.get(chrom, [])
            s = np.asarray([e[1] for e in edges], np.int64)
            e_ = np.asarray([e[2] for e in edges], np.int64)
            cn = np.asarray([e[3] for e in edges], float)
            # interval index per edge: first interval whose end >= start
            idx = np.searchsorted(ive, s)
            lens = (e_ - s) * self.scale
            cum = np.concatenate([[0.0], np.cumsum(lens)])
            x1 = x0 + idx * margin + cum[:-1]
            x2 = x0 + idx * margin + cum[1:]
            # interval origins: x at the first edge of each interval; an
            # interval with no edges still sits after ALL preceding edge
            # lengths (searchsorted gives the cumulative length up to the
            # first edge of any later interval — the running-cursor
            # semantics of the reference walk)
            self.starts[chrom] = [
                float(x0 + k * margin + cum[np.searchsorted(idx, k)])
                for k in range(len(ivs))
            ]
            bar_chrom += [chrom] * len(edges)
            bar_x1.append(x1)
            bar_x2.append(x2)
            bar_cn.append(cn)
            bar_s.append(s)
            bar_e.append(e_)
            # next chrom starts one margin after this chrom's last edge
            if len(edges):
                x0 = float(x0 + idx[-1] * margin + cum[-1] + margin)
            else:
                x0 = float(x0 + margin)
        self.bar_chrom = np.asarray(bar_chrom)
        self.bar_x1 = np.concatenate(bar_x1) if bar_x1 else np.zeros(0)
        self.bar_x2 = np.concatenate(bar_x2) if bar_x2 else np.zeros(0)
        self.bar_cn = np.concatenate(bar_cn) if bar_cn else np.zeros(0)
        self.bar_s = np.concatenate(bar_s) if bar_s else np.zeros(0, np.int64)
        self.bar_e = np.concatenate(bar_e) if bar_e else np.zeros(0, np.int64)

    def pos_x(self, chrom: str, pos) -> Tuple[np.ndarray, np.ndarray]:
        """Interval-linear map: figure x (and interval index) for genome
        positions on ``chrom``.  Vectorized over ``pos``."""
        pos = np.asarray(pos)
        idx = np.searchsorted(self._iv_end[chrom], pos)
        x0 = np.asarray(self.starts[chrom])[idx]
        return x0 + (pos - self._iv_start[chrom][idx]) * self.scale, idx


class Gene:
    def __init__(self, chrom, start, end, fields):
        self.gchrom = chrom
        self.gstart = start
        self.gend = end
        self.gname = fields[-4]
        self.strand = fields[3]
        self.height = 0.5
        estarts = [int(x) for x in fields[9].rsplit(",") if x]
        eends = [int(x) for x in fields[10].rsplit(",") if x]
        self.eposns = list(zip(estarts, eends))


def _find_annotation(name: str) -> Optional[str]:
    # the working directory is searched at CALL time (not frozen at
    # import), so user-provided refGene files next to the invocation work
    for d in ANNOTATIONS_DIRS + [os.getcwd()]:
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
    return None


class AmpliconVisualizer:
    def __init__(self):
        self.bam: Optional[BamFile] = None
        self.max_cn = 0.0
        self.sequence_edges_by_chr: Dict[str, list] = {}
        self.intervals_from_graph: Dict[str, list] = {}
        self.num_amplified_intervals = 0
        self.intervals_from_cycle: Dict[str, list] = {}
        self.discordant_edges: List[list] = []
        self.cycles: Dict[str, list] = {}
        self.cycle_flags: Dict[str, list] = {}
        self.genes: Dict[str, List[Gene]] = defaultdict(list)
        self.plot_bounds: Optional[Tuple[str, int, int]] = None

    # -- inputs -----------------------------------------------------------

    def open_bam(self, bam_fn: str) -> None:
        self.bam = BamFile(bam_fn)

    def parse_genes(self, ref, gene_subset_list=None, restrict_to_bushman=False):
        if ref in ("GRCh37", "hg19"):
            refgene_name = "refGene_hg19.txt"
        elif ref in ("GRCm38", "mm10"):
            refgene_name = "refGene_mm10.txt"
        else:
            refgene_name = f"refGene_{ref}.txt"
        bushman = set()
        if restrict_to_bushman:
            p = _find_annotation("Bushman_group_allOnco_May2018.tsv")
            if p is None:
                # built-in set (same facts the reference ships as a tsv,
                # extracted with its exact parse — annotations_bushman.py)
                from ..annotations_bushman import BUSHMAN_ONCO_GENES

                bushman = set(BUSHMAN_ONCO_GENES)
            else:
                with open(p) as fp:
                    next(fp)
                    for line in fp:
                        fields = line.rstrip().rsplit()
                        if fields:
                            bushman.add(fields[-1].strip('"'))
        path = _find_annotation(refgene_name)
        if path is None:
            logger.warning("refGene annotation %s not found; gene track will "
                           "be empty", refgene_name)
            return
        seen = set()
        with open(path) as fp:
            for line in fp:
                fields = line.rsplit("\t")
                chrom = fields[2]
                if ref in ("GRCh37", "GRCm38") and not chrom.startswith("hpv"):
                    chrom = chrom[3:]
                tstart, tend = int(fields[4]), int(fields[5])
                gname = fields[-4]
                if gname.startswith(("LOC", "LINC", "MIR")):
                    continue
                if restrict_to_bushman and gname not in bushman:
                    continue
                if gene_subset_list and gname not in gene_subset_list:
                    continue
                if gname not in seen:
                    seen.add(gname)
                    self.genes[chrom].append(Gene(chrom, tstart, tend, fields))

    def genes_overlapping(self, chrom, start, end) -> List[Gene]:
        return [g for g in self.genes.get(chrom, [])
                if g.gstart < end and g.gend > start]

    def parse_graph_file(self, graph_fn: str) -> None:
        with open(graph_fn) as fp:
            for line in fp:
                s = line.strip().split("\t")
                if s[0] == "sequence":
                    chrom = s[1].split(":")[0]
                    start = int(s[1].split(":")[1][:-1])
                    end = int(s[2].split(":")[1][:-1])
                    self.sequence_edges_by_chr.setdefault(chrom, []).append(
                        [chrom, start, end, float(s[3]), int(s[6]), int(s[5])])
                    self.max_cn = max(self.max_cn, float(s[3]))
                elif s[0] == "discordant":
                    b1, b2 = s[1].split("->")
                    chr1, p1 = b1.split(":")
                    chr2, p2 = b2.split(":")
                    self.discordant_edges.append(
                        [chr1, int(p1[:-1]), p1[-1], chr2, int(p2[:-1]), p2[-1],
                         float(s[2]), int(s[3])])

    def parse_cycle_file(self, cycle_fn, output_prefix, num_cycles=None) -> None:
        if cycle_fn.endswith("_cycles.txt"):
            init_char = "" if output_prefix.endswith("/") else "_"
            conv = output_prefix + init_char + "converted_"
            if num_cycles:
                conv += str(num_cycles) + "_"
            conv += "cycles.bed"
            # Reference quirk (plot_amplicons.py:144): num_cycles is passed
            # POSITIONALLY into convert_cycles_to_bed's rotate_to_min slot,
            # so --num_cycles turns ON min-rotation and does NOT head-limit
            # the conversion; the limit happens at plot time instead
            # (CoRAL.py-driven plotcycle num_cycles filter, :591-592,956-957).
            cycle2bed.convert_cycles_to_bed(
                cycle_fn, conv, rotate_to_min=bool(num_cycles))
            cycle_fn = conv
        elif not cycle_fn.endswith(".bed"):
            sys.exit("Cycles file must be either a valid *_cycles.txt file "
                     "or a converted .bed file!")
        with open(cycle_fn) as fp:
            for line in fp:
                s = line.strip().split("\t")
                if s[0][0] == "#":
                    continue
                self.cycles.setdefault(s[4], []).append(
                    [s[0], int(s[1]), int(s[2]), s[3]])
                if s[4] not in self.cycle_flags:
                    self.cycle_flags[s[4]] = [s[5] == "True", float(s[6])]

    # -- interval layout --------------------------------------------------

    def graph_amplified_intervals(self) -> None:
        for chrom, edges in self.sequence_edges_by_chr.items():
            lstart, lend = -2, -2
            out = self.intervals_from_graph.setdefault(chrom, [])
            for se in edges:
                if se[1] != lend + 1:
                    if lstart >= 0:
                        out.append([lstart, lend])
                        self.num_amplified_intervals += 1
                    lstart, lend = se[1], se[2]
                else:
                    lend = se[2]
            out.append([lstart, lend])
            self.num_amplified_intervals += 1

    @staticmethod
    def merge_intervals(intervals, padding=0.0):
        sorted_iv = sorted(intervals)
        merged = [sorted_iv[0]]
        for cur in sorted_iv[1:]:
            prev = merged[-1]
            if cur[0] <= prev[1] + padding:
                merged[-1] = (prev[0], max(prev[1], cur[1]))
            else:
                merged.append(cur)
        return merged

    def cycle_amplified_intervals(self, cycle_ids=None, cycle_only=False,
                                  graph_given=False) -> None:
        self.num_amplified_intervals = 0
        if cycle_ids is None:
            cycle_ids = list(self.cycle_flags)
        if cycle_only:
            cycle_ids = [c for c in self.cycle_flags if self.cycle_flags[c][0]]
        if graph_given:
            for cid in cycle_ids:
                for seg in self.cycles[cid]:
                    for iv in self.intervals_from_graph.get(seg[0], []):
                        if seg[1] >= iv[0] and seg[2] <= iv[1]:
                            bucket = self.intervals_from_cycle.setdefault(seg[0], [])
                            if iv not in bucket:
                                bucket.append(iv)
                            break
        else:
            by_chr = defaultdict(list)
            for cid in self.cycles:
                for seg in self.cycles[cid]:
                    by_chr[seg[0]].append((seg[1], seg[2]))
            for chrom, ivs in by_chr.items():
                self.intervals_from_cycle[chrom] = self.merge_intervals(
                    ivs, padding=10000)
        for chrom in self.intervals_from_cycle:
            self.intervals_from_cycle[chrom].sort()
            self.num_amplified_intervals += len(self.intervals_from_cycle[chrom])

    def set_gene_heights(self, rel_genes, padding=0.0) -> None:
        if not rel_genes:
            return
        merged = self.merge_intervals(
            [(g.gstart, g.gend) for g in rel_genes], padding=padding)
        for mi in merged:
            hits = [g for g in rel_genes if g.gstart < mi[1] and g.gend > mi[0]]
            heights = np.linspace(0.15, 0.75, len(hits))
            for g, h in zip(hits, heights):
                g.height = h

    # -- graph plot -------------------------------------------------------

    def plot_graph(self, title, output_fn, margin=2, height=7.5, fontsize=18,
                   dpi=300, max_cov_cutoff=float("inf"), quality_threshold=0,
                   hide_genes=False, gene_font_size=12) -> None:
        width = 15 if self.plot_bounds else max(15, 2 * self.num_amplified_intervals)
        fig = plt.figure(figsize=(width, height))
        gs = gridspec.GridSpec(
            2, 1, height_ratios=[8, 2 if not hide_genes else 0.000001])
        ax = fig.add_subplot(gs[0, 0])
        plt.subplots_adjust(left=0.073, right=1 - 0.073, bottom=0.25, top=0.95)
        ax.set_title(title, fontsize=fontsize)
        ax2 = ax.twinx()
        ax3 = fig.add_subplot(gs[1, 0], sharex=ax)
        ax.xaxis.set_visible(False)
        ax2.xaxis.set_visible(False)
        ax3.yaxis.set_visible(False)
        for side in ("left", "right", "top"):
            ax3.spines[side].set_visible(False)

        total_len_amp = sum(
            iv[1] - iv[0] + 1
            for ivs in self.intervals_from_graph.values() for iv in ivs)
        zoom = 1.0
        if self.plot_bounds:
            zoom = float(self.plot_bounds[2] - self.plot_bounds[1]) / total_len_amp
        sorted_chrs = sort_chrom_names(self.intervals_from_graph.keys())
        layout = GraphLayout(sorted_chrs, self.intervals_from_graph,
                             self.sequence_edges_by_chr, margin, total_len_amp)
        starts = layout.starts

        # CN bars: one LineCollection over the flat sequence-edge table
        visible = np.ones(len(layout.bar_cn), bool)
        if self.plot_bounds:
            visible = (layout.bar_chrom == self.plot_bounds[0]) \
                & (layout.bar_e >= self.plot_bounds[1]) \
                & (layout.bar_s <= self.plot_bounds[2])
        ymax = float(layout.bar_cn[visible].max()) if visible.any() else 0
        segs = np.stack([
            np.stack([layout.bar_x1[visible], layout.bar_cn[visible]], axis=1),
            np.stack([layout.bar_x2[visible], layout.bar_cn[visible]], axis=1),
        ], axis=1)
        ax2.add_collection(LineCollection(
            segs, colors="black", linewidths=6, zorder=2))

        if not self.plot_bounds:
            for chrom in starts:
                if chrom != sorted_chrs[0]:
                    for a in (ax, ax3):
                        a.axvline(x=starts[chrom][0] - margin * 0.5,
                                  linestyle="--", lw=2, zorder=2)
                for i in range(1, len(starts[chrom])):
                    ax.axvline(x=starts[chrom][i] - margin * 0.5,
                               linestyle=":", lw=2, zorder=2)

        # discordant-edge arcs (orientation color code, ref :339); endpoint
        # x-positions come from the layout's vectorized interval-linear map
        colorcode = {"+-": "red", "++": "magenta",
                     "-+": (139 / 256.0, 69 / 256.0, 19 / 256.0), "--": "teal"}
        avg_rc = sum(bp[7] for bp in self.discordant_edges) * 1.0 / max(
            len(self.discordant_edges), 1)
        placeable = []
        for bp in self.discordant_edges:
            if bp[0] in self.intervals_from_graph \
                    and bp[3] in self.intervals_from_graph:
                placeable.append(bp)
            else:
                print("Could not place " + str(bp))
        if placeable:
            def batched_pos_x(chroms, poss):
                # pos_x is vectorized per chromosome: two calls per
                # distinct chrom instead of one tiny call per breakpoint
                chroms = np.asarray(chroms)
                poss = np.asarray(poss, np.int64)
                out = np.zeros(len(poss))
                for c in np.unique(chroms):
                    m = chroms == c
                    out[m] = layout.pos_x(str(c), poss[m])[0]
                return out

            xs1 = batched_pos_x([bp[0] for bp in placeable],
                                [bp[1] for bp in placeable])
            xs2 = batched_pos_x([bp[3] for bp in placeable],
                                [bp[4] for bp in placeable])
            for bp, x1, x2 in zip(placeable, xs1, xs2):
                if self.plot_bounds:
                    hit1 = (bp[0] == self.plot_bounds[0]
                            and self.plot_bounds[1] <= bp[1] <= self.plot_bounds[2])
                    hit2 = (bp[3] == self.plot_bounds[0]
                            and self.plot_bounds[1] <= bp[4] <= self.plot_bounds[2])
                    if not hit1 and not hit2:
                        continue
                arc = Arc(((x1 + x2) * 0.5, 0), x1 - x2, 2 * ymax, theta1=0,
                          theta2=180, color=colorcode[bp[2] + bp[5]],
                          lw=min(3 * (bp[7] / avg_rc), 3), zorder=3)
                ax2.add_patch(arc)
        ax2.set_ylim(0, 1.4 * ymax)
        ax2.set_ylabel("CN", fontsize=fontsize)
        ax2.tick_params(axis="y", labelsize=fontsize)

        # windowed coverage: one exact profile per interval, window sums by
        # reduceat, all bars in one PatchCollection
        max_cov = 0.0
        cov_patches = []
        for chrom in sorted_chrs:
            for inti, iv in enumerate(self.intervals_from_graph[chrom]):
                if self.plot_bounds:
                    if chrom != self.plot_bounds[0]:
                        continue
                    if not (iv[1] >= self.plot_bounds[1]
                            and iv[0] <= self.plot_bounds[2]):
                        continue
                ival_len = iv[1] - iv[0]
                if self.plot_bounds:
                    ival_len = self.plot_bounds[2] - self.plot_bounds[1]
                window = 150
                if ival_len >= 1_000_000:
                    window = 10_000
                elif ival_len >= 100_000:
                    window = 1_000
                profile = np.asarray(self.bam.coverage_profile(
                    chrom, iv[0], iv[1] + window,
                    quality_threshold=int(quality_threshold)), float)
                w0 = np.arange(iv[0], iv[1], window)
                if not len(w0):
                    continue
                covs = np.add.reduceat(profile, w0 - iv[0]) / window
                # reduceat's final slice runs to the profile end; re-cut it
                # to one window to match the per-window contract
                if len(w0):
                    covs[-1] = profile[w0[-1] - iv[0]: w0[-1] - iv[0] + window].sum() / window
                    max_cov = max(max_cov, float(covs.max()))
                xw = starts[chrom][inti] + (w0 - iv[0]) * 100.0 / total_len_amp
                cov_patches.extend(
                    Rectangle((x, 0), window * 100.0 / total_len_amp, c)
                    for x, c in zip(xw, covs))
                # the reference draws ONE extra (overlapping) tail window
                # whenever the interval length+1 is not a window multiple
                # (plot_amplicons.py:406-414) — same rect, same max_cov fold
                wt = iv[1] - ((iv[1] - iv[0] + 1) % window)
                if wt < iv[1]:
                    lo_rel = wt - iv[0]
                    if lo_rel >= 0:
                        c = float(profile[lo_rel: lo_rel + window].sum()
                                  ) / window
                    else:
                        # interval shorter than the window: the tail
                        # window starts BEFORE the interval, outside the
                        # prefetched profile — the reference queries the
                        # genome there (count_coverage(wt, wt+window),
                        # plot_amplicons.py:407-409); a negative profile
                        # slice would silently yield coverage 0
                        c = float(np.asarray(self.bam.coverage_profile(
                            chrom, wt, wt + window,
                            quality_threshold=int(quality_threshold)),
                            float).sum()) / window
                    max_cov = max(max_cov, c)
                    xt = starts[chrom][inti] + \
                        (wt - iv[0]) * 100.0 / total_len_amp
                    cov_patches.append(
                        Rectangle((xt, 0), window * 100.0 / total_len_amp, c))
        ax.add_collection(PatchCollection(
            cov_patches, facecolor="silver", edgecolor="silver", zorder=1))
        ax.set_ylabel("Coverage", fontsize=fontsize)
        ax.set_ylim(0, min(1.25 * max_cov, max_cov_cutoff) or 1.0)
        ax.tick_params(axis="y", labelsize=fontsize)

        if not hide_genes:
            self._draw_gene_track(
                ax3, sorted_chrs, self.intervals_from_graph, starts,
                total_len_amp, gene_font_size, zoom)

        # ticks/labels
        if not self.plot_bounds:
            lim = 100 + (self.num_amplified_intervals + 1) * margin
            for a in (ax, ax2, ax3):
                a.set_xlim(0, lim)
            xtickpos, xticklabels = self._interval_ticks(
                sorted_chrs, self.intervals_from_graph, starts, margin)
            ax3.set_xticks(xtickpos)
            ax3.set_xticklabels(xticklabels, size=fontsize)
            self._style_tick_labels(ax3, xticklabels, sorted_chrs)
        else:
            pchrom, pstart, pend = self.plot_bounds
            relint = None
            for inti, iv in enumerate(self.intervals_from_graph.get(pchrom, [])):
                if iv[0] <= pstart <= iv[1]:
                    relint, rint_ = inti, iv
                    break
            if relint is None:
                print(f"Could not identify region {pchrom}:{pstart}-{pend} in "
                      "graph regions. Region should be fully contained in graph.")
            else:
                ps = starts[pchrom][relint] + (pstart - rint_[0]) * 100.0 / total_len_amp
                pe = starts[pchrom][relint] + (pend - rint_[0]) * 100.0 / total_len_amp
                ax3.set_xticks([ps, pe])
                ax3.set_xticklabels(
                    [f"{pchrom}:{pstart}", f"{pchrom}:{pend}"], size=fontsize - 4)
                for a in (ax, ax2, ax3):
                    a.set_xlim(ps, pe)
        ax3.yaxis.set_major_formatter(ticker.NullFormatter())
        ax3.set_ylim(0, 1)
        fig.subplots_adjust(hspace=0)
        plt.savefig(output_fn + ".png", dpi=dpi)
        plt.savefig(output_fn + ".pdf")
        plt.close(fig)

    def _draw_gene_track(self, ax3, sorted_chrs, intervals, starts,
                         total_len_amp, gene_font_size, zoom=1.0,
                         respect_bounds=True) -> None:
        # respect_bounds: the --region zoom applies to the GRAPH figure
        # only — the reference's plotcycle ignores it entirely
        # (src/plot_amplicons.py:806-848), so the cycles figure passes
        # respect_bounds=False
        bounds = self.plot_bounds if respect_bounds else None
        for chrom in sorted_chrs:
            for inti, iv in enumerate(intervals[chrom]):
                if bounds:
                    if chrom != bounds[0]:
                        continue
                    if not (iv[1] >= bounds[1]
                            and iv[0] <= bounds[2]):
                        continue
                rel = self.genes_overlapping(chrom, iv[0], iv[1])
                self.set_gene_heights(rel, total_len_amp * 0.02)
                for g in rel:
                    h = g.height
                    cut_gs = max(iv[0], g.gstart)
                    cut_ge = min(iv[1], g.gend)
                    gx1 = starts[chrom][inti] + (cut_gs - iv[0]) * 100.0 / total_len_amp
                    gx2 = starts[chrom][inti] + (cut_ge - iv[0]) * 100.0 / total_len_amp
                    ax3.hlines(h, gx1, gx2, color="cornflowerblue", lw=4.5)
                    if bounds:
                        if cut_ge < bounds[1] or cut_gs > bounds[2]:
                            continue
                        cut_gs = max(bounds[1], cut_gs)
                        cut_ge = min(bounds[2], cut_ge)
                        gx1 = starts[chrom][inti] + (cut_gs - iv[0]) * 100.0 / total_len_amp
                        gx2 = starts[chrom][inti] + (cut_ge - iv[0]) * 100.0 / total_len_amp
                    ax3.text((gx1 + gx2) / 2, h + 0.05, g.gname, ha="center",
                             va="bottom", fontsize=gene_font_size, style="italic")
                    if g.strand == "+":
                        ax3.plot(gx1, h, marker=">", color="black", markersize=7)
                    elif g.strand == "-":
                        ax3.plot(gx2, h, marker="<", color="black", markersize=7)
                    for es, ee in g.eposns:
                        if not ee > iv[0] or not es < iv[1]:
                            continue
                        ex1 = starts[chrom][inti] + (max(iv[0], es) - iv[0]) \
                            * 100.0 / total_len_amp
                        ex2 = starts[chrom][inti] + (min(iv[1], ee) - iv[0]) \
                            * 100.0 / total_len_amp
                        min_w = 0.2 * zoom
                        if ex2 - ex1 < min_w:
                            d = (min_w - (ex2 - ex1)) / 2
                            ex1 -= d
                            ex2 += d
                        ax3.hlines(h, ex1, ex2, color="black", lw=7.5)

    @staticmethod
    def _interval_ticks(sorted_chrs, intervals, starts, margin):
        xtickpos, xticklabels = [], []
        num_amplified = sum(len(intervals[c]) for c in sorted_chrs)
        for chrom in sorted_chrs:
            nint = len(intervals[chrom])
            for inti in range(len(starts[chrom])):
                if inti > 0:
                    xtickpos.append(starts[chrom][inti] - margin)
                    if nint % 2 == 0 and inti == (nint - 2) // 2 + 1:
                        xtickpos.append(starts[chrom][inti] - margin * 0.5)
                    xtickpos.append(starts[chrom][inti])
                    if nint % 2 == 1 and inti == (nint - 1) // 2:
                        xtickpos.append(
                            (starts[chrom][inti] + starts[chrom][inti + 1]
                             - margin) * 0.5)
                else:
                    if chrom != sorted_chrs[0]:
                        xtickpos.append(starts[chrom][0] - margin)
                    xtickpos.append(starts[chrom][0])
                    if nint % 2 == 1 and inti == (nint - 1) // 2:
                        chri = sorted_chrs.index(chrom)
                        if chri == len(sorted_chrs) - 1:
                            end = 100 + num_amplified * margin
                        else:
                            end = starts[sorted_chrs[chri + 1]][0] - margin
                        xtickpos.append((starts[chrom][inti] + end) * 0.5)
        xtickpos.append(100 + num_amplified * margin)
        for chrom in sorted_chrs:
            nint = len(intervals[chrom])
            for inti in range(nint):
                iv = intervals[chrom][inti]
                xticklabels.append(str(iv[0]) + "   ")
                if nint % 2 == 1 and inti == (nint - 1) // 2:
                    xticklabels.append(chrom)
                xticklabels.append(str(iv[1]) + "   ")
                if nint % 2 == 0 and inti == (nint - 2) // 2:
                    xticklabels.append(chrom)
        return xtickpos, xticklabels

    @staticmethod
    def _style_tick_labels(ax3, xticklabels, sorted_chrs):
        labels = ax3.get_xticklabels()
        for ti in range(min(len(xticklabels), len(labels))):
            if xticklabels[ti] not in sorted_chrs:
                labels[ti].set_rotation(90)
            else:
                ax3.xaxis.get_major_ticks()[ti].tick1line.set_visible(False)

    # -- cycles plot ------------------------------------------------------

    def plot_cycles(self, title, output_fn, num_cycles=-1, cycle_only=False,
                    margin=2, fontsize=18, dpi=300, hide_genes=False,
                    gene_font_size=12) -> None:
        width = max(15, 2 * self.num_amplified_intervals)
        to_plot = list(self.cycles.keys())
        if num_cycles > 0:
            to_plot = [c for c in to_plot if int(c) <= num_cycles]
        if cycle_only:
            to_plot = [c for c in to_plot if self.cycle_flags[c][0]]
        to_plot = sorted(to_plot)
        height = sum(2 * len(self.cycles[c]) - 1 for c in to_plot) \
            + 6 * (len(to_plot) - 1)
        fig = plt.figure(figsize=(width, max(4, height * 0.25)))
        gs = gridspec.GridSpec(
            2, 1, height_ratios=[8, 50 / height if not hide_genes else 0.000001])
        ax = fig.add_subplot(gs[0, 0])
        ax.set_title(title, fontsize=fontsize)
        ax.xaxis.set_visible(False)
        ax3 = fig.add_subplot(gs[1, 0], sharex=ax)
        ax3.yaxis.set_visible(False)
        for side in ("left", "right", "top"):
            ax3.spines[side].set_visible(False)

        total_len_amp = sum(
            iv[1] - iv[0] + 1
            for ivs in self.intervals_from_cycle.values() for iv in ivs)
        sorted_chrs = sort_chrom_names(self.intervals_from_cycle.keys())
        starts: Dict[str, list] = {}
        x = margin
        for chrom in sorted_chrs:
            starts[chrom] = [x]
            ivs = self.intervals_from_cycle[chrom]
            for inti, iv in enumerate(ivs):
                x += (iv[1] - iv[0]) * 100.0 / total_len_amp + margin
                if inti < len(ivs) - 1:
                    starts[chrom].append(x)
        for chrom in starts:
            if chrom != sorted_chrs[0]:
                for a in (ax, ax3):
                    a.axvline(x=starts[chrom][0] - margin * 0.5,
                              linestyle="--", lw=2)
            for i in range(1, len(starts[chrom])):
                ax.axvline(x=starts[chrom][i] - margin * 0.5, linestyle=":", lw=2)

        def seg_x(seg, which):
            """x coordinate of a segment's start (1) or end (2)."""
            idx = 0
            while seg[1] > self.intervals_from_cycle[seg[0]][idx][1]:
                idx += 1
            base = starts[seg[0]][idx]
            origin = self.intervals_from_cycle[seg[0]][idx][0]
            pos = seg[1] if which == 1 else seg[2]
            return base + (pos - origin) * 100.0 / total_len_amp

        y_cur = -2
        ext = 1.5
        cycleticks, cycleticklabels = [], []
        for cid in to_plot:
            ystart = y_cur
            cyc_min_x, cyc_max_x = float("inf"), 0.0
            segs = self.cycles[cid]
            for i, seg in enumerate(segs):
                x1 = seg_x(seg, 1)
                xlen = (seg[2] - seg[1]) * 100.0 / total_len_amp
                cyc_min_x = min(cyc_min_x, x1)
                cyc_max_x = max(cyc_max_x, x1 + xlen)
                ax.add_patch(Rectangle((x1, y_cur), xlen, 1,
                                       facecolor="antiquewhite", linewidth=2,
                                       edgecolor="dimgrey"))
                if i < len(segs) - 1:
                    nseg = segs[i + 1]
                    if seg[3] == "+" and nseg[3] == "-":
                        x2, x2n = x1 + xlen, seg_x(nseg, 2)
                        ax.vlines(max(x2, x2n) + ext, y_cur + 0.5, y_cur - 1.5,
                                  colors="b", lw=2)
                        ax.hlines(y_cur + 0.5, x2, max(x2, x2n) + ext, colors="b", lw=2)
                        ax.hlines(y_cur - 1.5, x2n, max(x2, x2n) + ext, colors="b", lw=2)
                        y_cur -= 2
                    elif seg[3] == "-" and nseg[3] == "+":
                        x1n = seg_x(nseg, 1)
                        ax.vlines(min(x1, x1n) - ext, y_cur + 0.5, y_cur - 1.5,
                                  colors="b", lw=2)
                        ax.hlines(y_cur + 0.5, min(x1, x1n) - ext, x1, colors="b", lw=2)
                        ax.hlines(y_cur - 1.5, min(x1, x1n) - ext, x1n, colors="b", lw=2)
                        y_cur -= 2
                    elif seg[3] == "+" and nseg[3] == "+":
                        x2, x1n = x1 + xlen, seg_x(nseg, 1)
                        if x2 <= x1n:
                            ax.hlines(y_cur + 0.5, x2, x1n, colors="b", lw=2)
                        else:
                            ax.vlines(x2 + ext, y_cur - 0.5, y_cur + 0.5, colors="b", lw=2)
                            ax.vlines(x1n - ext, y_cur - 1.5, y_cur - 0.5, colors="b", lw=2)
                            ax.hlines(y_cur + 0.5, x2, x2 + ext, colors="b", lw=2)
                            ax.hlines(y_cur - 0.5, x1n - ext, x2 + ext, colors="b", lw=2)
                            ax.hlines(y_cur - 1.5, x1n - ext, x1n, colors="b", lw=2)
                            y_cur -= 2
                    else:
                        x2n = seg_x(nseg, 2)
                        if x1 >= x2n:
                            ax.hlines(y_cur + 0.5, x2n, x1, colors="b", lw=2)
                        else:
                            ax.vlines(x1 - ext, y_cur - 0.5, y_cur + 0.5, colors="b", lw=2)
                            ax.vlines(x2n + ext, y_cur - 1.5, y_cur - 0.5, colors="b", lw=2)
                            ax.hlines(y_cur + 0.5, x1 - ext, x1, colors="b", lw=2)
                            ax.hlines(y_cur - 0.5, x1 - ext, x2n + ext, colors="b", lw=2)
                            ax.hlines(y_cur - 1.5, x2n, x2n + ext, colors="b", lw=2)
                            y_cur -= 2
            # terminal connectors
            if not self.cycle_flags[cid][0]:  # path
                seg = segs[0]
                if seg[3] == "+":
                    xx = seg_x(seg, 1)
                    ax.hlines(ystart + 0.5, xx - 2 * ext, xx, colors="b", lw=2)
                else:
                    xx = seg_x(seg, 2)
                    ax.hlines(ystart + 0.5, xx, xx + 2 * ext, colors="b", lw=2)
                seg = segs[-1]
                if seg[3] == "+":
                    xx = seg_x(seg, 2)
                    ax.hlines(y_cur + 0.5, xx, xx + 2 * ext, colors="b", lw=2)
                else:
                    xx = seg_x(seg, 1)
                    ax.hlines(y_cur + 0.5, xx - 2 * ext, xx, colors="b", lw=2)
            else:  # cycle wrap-around
                xmin_, xmax_ = cyc_min_x - ext, cyc_max_x + ext
                if len(segs) > 1:
                    xmin_ -= ext
                    xmax_ += ext
                seg1, seg2 = segs[0], segs[-1]
                if seg1[3] == "-" and seg2[3] == "+":
                    ax.vlines(xmax_, y_cur + 0.5, ystart + 0.5, colors="b", lw=2)
                    ax.hlines(ystart + 0.5, seg_x(seg1, 2), xmax_, colors="b", lw=2)
                    ax.hlines(y_cur + 0.5, seg_x(seg2, 2), xmax_, colors="b", lw=2)
                elif seg1[3] == "+" and seg2[3] == "-":
                    ax.vlines(xmin_, y_cur + 0.5, ystart + 0.5, colors="b", lw=2)
                    ax.hlines(ystart + 0.5, xmin_, seg_x(seg1, 1), colors="b", lw=2)
                    ax.hlines(y_cur + 0.5, xmin_, seg_x(seg2, 1), colors="b", lw=2)
                elif seg1[3] == "-" and seg2[3] == "-":
                    x1n = seg_x(seg2, 1)
                    ax.vlines(xmax_, y_cur - 0.5, ystart + 0.5, colors="b", lw=2)
                    ax.vlines(x1n - ext, y_cur - 0.5, y_cur + 0.5, colors="b", lw=2)
                    ax.hlines(ystart + 0.5, seg_x(seg1, 2), xmax_, colors="b", lw=2)
                    ax.hlines(y_cur + 0.5, x1n - ext, x1n, colors="b", lw=2)
                    ax.hlines(y_cur - 0.5, x1n - ext, xmax_, colors="b", lw=2)
                else:
                    x2n = seg_x(seg2, 2)
                    ax.vlines(xmin_, y_cur - 0.5, ystart + 0.5, colors="b", lw=2)
                    ax.vlines(x2n + ext, y_cur - 0.5, y_cur + 0.5, colors="b", lw=2)
                    ax.hlines(ystart + 0.5, xmin_, seg_x(seg1, 1), colors="b", lw=2)
                    ax.hlines(y_cur + 0.5, x2n, x2n + ext, colors="b", lw=2)
                    ax.hlines(y_cur - 0.5, xmin_, x2n + ext, colors="b", lw=2)
            ax.hlines(y_cur - 2, -1,
                      101 + (self.num_amplified_intervals + 1) * margin, colors="k")
            cycleticks.append((y_cur + ystart) * 0.5)
            kind = "cycle" if self.cycle_flags[cid][0] else "path"
            cycleticklabels.append(
                f"{kind} {cid}:\nCN = {round(self.cycle_flags[cid][1], 2)}")
            y_cur -= 4

        if not hide_genes:
            self._draw_gene_track(ax3, sorted_chrs, self.intervals_from_cycle,
                                  starts, total_len_amp, gene_font_size,
                                  respect_bounds=False)

        ax.set_xlim(-1, 101 + (self.num_amplified_intervals + 1) * margin)
        ax.set_ylim(y_cur + 2, 0)
        xtickpos, xticklabels = self._interval_ticks(
            sorted_chrs, self.intervals_from_cycle, starts, margin)
        ax3.set_xticks(xtickpos)
        ax3.set_xticklabels(xticklabels, size=fontsize)
        self._style_tick_labels(ax3, xticklabels, sorted_chrs)
        ax.set_yticks(cycleticks)
        ax.set_yticklabels(cycleticklabels, fontsize=fontsize)
        for side in ("top", "right", "left", "bottom"):
            ax.spines[side].set_visible(False)
        # the reference calls tight_layout here too (plot_amplicons.py:898)
        # and on dense cycle pages matplotlib declines it with a
        # UserWarning on BOTH sides; the no-op is part of the visual
        # contract (geometry differentials pass), so the warning is noise
        import warnings

        with warnings.catch_warnings():
            warnings.filterwarnings(
                "ignore", message="Tight layout not applied")
            plt.tight_layout()
        ax3.yaxis.set_major_formatter(ticker.NullFormatter())
        ax3.set_ylim(0, 1)
        fig.subplots_adjust(hspace=0)
        plt.savefig(output_fn + ".png", dpi=dpi)
        plt.savefig(output_fn + ".pdf")
        plt.close(fig)

    def close_bam(self) -> None:
        if self.bam is not None:
            self.bam.close()


def plot_amplicons(args) -> None:
    """Plot-mode driver (reference ``plot_amplicons``, ``plot_amplicons.py:
    906-961``)."""
    if args.plot_graph:
        if not args.graph:
            sys.exit("Please specify the breakpoint graph file to plot.")
        if not args.bam:
            sys.exit("Please specify the bam file to plot.")
    if args.plot_cycles and not args.cycles:
        sys.exit("Please specify the cycle file, in *.bed format, to plot.")
    ref = "hg38" if args.ref == "GRCh38" else args.ref

    vis = AmpliconVisualizer()
    vis.parse_genes(ref, set(args.gene_subset_list), args.bushman_genes)
    gtitle = args.output_prefix.split("/")[-1]
    if args.plot_graph:
        vis.open_bam(args.bam)
        vis.parse_graph_file(args.graph)
        if args.region:
            pchrom = args.region.split(":")[0]
            pb1, pb2 = args.region.split(":")[1].rsplit("-")
            vis.plot_bounds = (pchrom, int(pb1), int(pb2))
        vis.graph_amplified_intervals()
        vis.plot_graph(gtitle, args.output_prefix + "_graph",
                       max_cov_cutoff=args.max_coverage,
                       quality_threshold=args.min_mapq,
                       hide_genes=args.hide_genes,
                       gene_font_size=args.gene_fontsize)
    if args.plot_cycles:
        vis.parse_cycle_file(args.cycles, args.output_prefix, args.num_cycles)
        cycle_ids = None
        if args.num_cycles:
            cycle_ids = [str(i + 1) for i in range(args.num_cycles)]
        graph_given = args.graph is not None
        if graph_given:
            vis.parse_graph_file(args.graph)
            vis.graph_amplified_intervals()
        vis.cycle_amplified_intervals(
            cycle_ids=cycle_ids, cycle_only=args.only_cyclic_paths,
            graph_given=graph_given)
        vis.plot_cycles(gtitle, args.output_prefix + "_cycles",
                        num_cycles=args.num_cycles or -1,
                        cycle_only=args.only_cyclic_paths,
                        hide_genes=args.hide_genes,
                        gene_font_size=args.gene_fontsize)
    vis.close_bam()
    print("Visualization completed.")
