"""HSR mode: detect chromosomal integration sites of ecDNA.

Behavioral port of the reference ``src/hsr.py:21-220``: re-collect
chimeric alignments, find breakpoints with exactly one side inside the
ecDNA intervals, cluster them with a coverage-scaled cutoff, and report/
plot candidate integration sites whose chromosomal side is not amplified.

Reference quirks preserved: the i-1/i+1 low-mapq rescue passes a LIST to
``interval_overlap`` (``hsr.py:143,148``) making its second clause always
true, so the rescue only requires the i-1 side to be outside the ecDNA
intervals; both rescue branches are identical.
"""
from __future__ import annotations

import logging
import os

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from .constants import CHR_SIZES
from .cycle2bed import convert_cycles_to_bed
from .io.bam import BamFile
from .io.cnv import read_cn_segments
from .ops.breakpoints import (
    bp_match,
    call_consensus_bp,
    cluster_breakpoints,
    interval_include,
    interval_overlap_l,
    interval_to_bp,
)
from .ops.chimera import collect_chimeras

logger = logging.getLogger(__name__)


def locate_hsrs(args) -> None:
    ecdna_intervals = []
    ecdna_intervals_ext = []
    cycle_fn = args.cycles
    if args.cycles.endswith("_cycles.txt"):
        init_char = "" if args.output_prefix.endswith("/") else "_"
        conv = args.output_prefix + init_char + "converted_cycles.bed"
        convert_cycles_to_bed(args.cycles, conv)
        cycle_fn = conv
    elif not args.cycles.endswith(".bed"):
        raise SystemExit(
            "Cycles file must be either a valid *_cycles.txt file or a "
            "converted .bed file!")
    with open(cycle_fn) as fp:
        for line in fp:
            if line.startswith("#"):
                continue
            s = line.strip().split()
            ecdna_intervals.append([s[0], int(s[1]), int(s[2])])
            ecdna_intervals_ext.append(
                [s[0], int(s[1]) - args.bp_match_cutoff,
                 int(s[2]) + args.bp_match_cutoff])
    print("ecDNA intervals:")
    for ival in ecdna_intervals:
        print(ival)

    cns_dict = {}
    for seg in read_cn_segments(args.cn_seg):
        cns_dict.setdefault(seg.chrom, []).append([seg.start, seg.end, seg.cn])

    bam = BamFile(args.lr_bam)
    _read_length, chimeras, _nm = collect_chimeras(bam)
    print("Fetched %d chimeric alignments." % len(chimeras))

    normal_cov = float(args.normal_cov)
    bp_list = []
    for rn, chim in chimeras.items():
        rr = chim.r
        q = chim.mapq
        rq = chim.q
        cycle_flag = False
        for interval in ecdna_intervals:
            i = interval_overlap_l(interval, rr)
            if i >= 0 and interval_include(rr[i], interval):
                cycle_flag = True
                break
        if not cycle_flag:
            continue
        assigned = [0] * max(len(rr) - 1, 0)
        for ri in range(len(rr) - 1):
            in1 = interval_overlap_l(rr[ri], ecdna_intervals)
            in2 = interval_overlap_l(rr[ri + 1], ecdna_intervals)
            if q[ri] >= 20 and q[ri + 1] >= 20 and \
                    ((in1 == -1 and in2 >= 0) or (in1 >= 0 and in2 == -1)):
                bp_list.append(
                    interval_to_bp(rr[ri], rr[ri + 1], (rn, ri, ri + 1),
                                   int(rq[ri + 1][0]) - int(rq[ri][1]))
                    + [q[ri], q[ri + 1]])
                assigned[ri] = 1
        for ri in range(1, len(rr) - 1):
            # rescue: i-1 side outside the ecDNA (the reference's second
            # clause is vacuously true — see module docstring)
            if assigned[ri - 1] == 0 and assigned[ri] == 0 and \
                    q[ri] < 10 and q[ri - 1] >= 20 and q[ri + 1] >= 20 and \
                    interval_overlap_l(rr[ri - 1], ecdna_intervals) == -1:
                bp_list.append(
                    interval_to_bp(rr[ri - 1], rr[ri + 1], (rn, ri - 1, ri + 1),
                                   int(rq[ri + 1][0]) - int(rq[ri - 1][1]))
                    + [q[ri - 1], q[ri + 1]])

    clusters = cluster_breakpoints(
        bp_list, normal_cov * 0.5, args.bp_match_cutoff_clustering)
    bp_refined = []
    for c in clusters:
        if len(c) < normal_cov * 0.5:
            continue
        remainder = c
        while len(remainder) >= normal_cov * 0.5:
            bp, bpr, stats, remainder = call_consensus_bp(
                remainder, args.bp_match_cutoff)
            if len(set(bpr)) >= normal_cov * 0.5:
                merged = False
                for existing in bp_refined:
                    if (bp[0] == existing[0] and bp[3] == existing[3]
                            and bp[2] == existing[2] and bp[5] == existing[5]
                            and abs(bp[1] - existing[1]) <= args.bp_match_cutoff
                            and abs(bp[4] - existing[4]) < args.bp_match_cutoff):
                        # crash-fix deviation: the reference stores a
                        # LIST here and `list |= set` TypeErrors on the
                        # first merge (reference src/hsr.py:166); we
                        # store a set so the merge its code intends works
                        existing[-1] |= set(bpr)
                        merged = True
                        break
                if not merged:
                    bp_refined.append(bp + [set(bpr)])
    print("Found %d breakpoints connecting ecDNA and chromosomes." % len(bp_refined))
    bam.close()

    # genome-wide scatter of integration loci (reference :174-220)
    sum_sizes = sum(CHR_SIZES.values())
    agg = 0
    xticks = []
    starting_pos = {}
    plt.figure(figsize=(20, 8))
    for chrom, size in CHR_SIZES.items():
        agg += size
        if agg < sum_sizes:
            plt.plot([agg * 100.0 / sum_sizes] * 2, [-1, 1000000],
                     "k--", linewidth=2)
        xticks.append((agg - 0.5 * size) * 100.0 / sum_sizes)
        starting_pos[chrom] = (agg - size) * 100.0 / sum_sizes

    def plot_side(chrom, pos, support):
        # crash-fix deviation: the reference indexes cns_dict[chrom]
        # directly and KeyErrors on a chromosome absent from the CN
        # calls (reference src/hsr.py:189); .get treats it as cn=0
        cn = 0.0
        for seg in cns_dict.get(chrom, []):
            if seg[0] < pos < seg[1]:
                cn = seg[2]
                break
        if cn <= 5.0 and support <= normal_cov * 2.5:
            print("Breakpoint", bp[:6], "Support = ", support)
            plt.plot(starting_pos[chrom] + pos * 100.0 / sum_sizes,
                     support, "bo")

    for bp in bp_refined:
        side1_in = interval_overlap_l([bp[0], bp[1], bp[1]], ecdna_intervals_ext) >= 0
        side2_in = interval_overlap_l([bp[3], bp[4], bp[4]], ecdna_intervals_ext) >= 0
        if side1_in and not side2_in and bp[3] in starting_pos:
            plot_side(bp[3], bp[4], len(bp[-1]))
        elif side2_in and not side1_in and bp[0] in starting_pos:
            plot_side(bp[0], bp[1], len(bp[-1]))

    plt.xlim([0, 100])
    plt.ylim([1, 500])
    plt.yscale("log")
    plt.xticks(xticks, list(range(1, 23)) + ["X", "Y"])
    plt.title(args.output_prefix + " integration loci", fontsize=25)
    plt.ylabel("Long read support", fontsize=25)
    plt.tight_layout()
    # reference names the scatter "integration_sites_" + output_prefix
    # (hsr.py:218-219), which CRASHES for absolute-path prefixes (invalid
    # path "integration_sites_/..."); prefix the basename instead so
    # relative-prefix behavior is unchanged
    head, tail = os.path.split(args.output_prefix)
    out_img = os.path.join(head, "integration_sites_" + tail)
    plt.savefig(out_img + ".png")
    plt.close()
    print("\nCreated " + out_img + ".png")
