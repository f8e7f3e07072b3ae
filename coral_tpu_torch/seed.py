"""Seed mode: CN-gain interval seeding.

Behavioral port of the reference seeding algorithm
(``src/cnv_seed.py:18-128``), restructured around the parsed CN-segment
table.  Every numerical rule is preserved, including its quirks:

* amplified-run formation only considers segments with ``cn >= gain`` lying
  entirely on one chromosome arm; non-qualifying segments neither extend nor
  break a run (ref ``:56-69``);
* a run spanning the centromere is an invariant violation (ref aborts via
  ``os.abort()`` at ``:108``; we raise);
* per-arm background CN is a length-weighted median-like scan over all arm
  segments, triggered only when they cover >= 50% of the arm (ref ``:72-92``);
* the final gap-merge resets the accumulated length to zero (not to the new
  segment's length) after each emitted seed, and silently drops a distant
  segment when the accumulated run is still too short (ref ``:112-128``);
* output rows are ``chrom\tstart\tend-1``.
"""
from __future__ import annotations

import logging
from typing import List, Optional, Sequence

from .annotations import chr_arms
from .config import SeedConfig
from .io.cnv import CnSegment, read_cn_segments

logger = logging.getLogger(__name__)


class SeedError(RuntimeError):
    pass


def _arm_background_cn(arm_segs: Sequence[CnSegment], arm_len: int) -> float:
    """Length-weighted median-like background CN of one arm (ref :76-91)."""
    covered = sum(s.end - s.start for s in arm_segs)
    if covered < 0.5 * arm_len:
        return 2.0
    ccn = 2.0
    acc = 0
    for seg in sorted(arm_segs, key=lambda s: s.cn):
        ccn = seg.cn
        acc += seg.end - seg.start
        if acc >= 0.49 * covered:
            break
    return ccn


def find_seeds(
    segments: Sequence[CnSegment],
    cfg: SeedConfig = SeedConfig(),
    centromeres=None,
) -> List[tuple]:
    """Compute CNV seed intervals.

    Returns a list of ``(chrom, start, end_inclusive)`` tuples, in emission
    order, matching the rows the reference writes to ``*_CNV_SEEDS.bed``.
    """
    arms = chr_arms(centromeres)

    # Pass 1: amplified-run formation + per-arm segment collection.
    runs: List[List[CnSegment]] = []
    cur: List[CnSegment] = []
    arm_segs = {c: ([], []) for c in arms}  # chrom -> (p-arm segs, q-arm segs)
    for seg in segments:
        if seg.chrom not in arms:
            continue
        cen_s, cen_e = arms[seg.chrom]["cen"]
        on_p = seg.end <= cen_s
        on_q = seg.start >= cen_e
        if seg.cn >= cfg.gain and (on_p or on_q):
            if cur and seg.chrom == cur[-1].chrom and seg.start - cur[-1].end <= cfg.max_seg_gap:
                cur.append(seg)
            else:
                if cur:
                    runs.append(cur)
                cur = [seg]
        if on_p:
            arm_segs[seg.chrom][0].append(seg)
        if on_q:
            arm_segs[seg.chrom][1].append(seg)
    if cur:
        runs.append(cur)

    # Pass 2: per-arm background CN.
    arm_cn = {}
    for chrom in arms:
        p_len, q_len = arms[chrom]["arm_sizes"]
        arm_cn[chrom] = (
            _arm_background_cn(arm_segs[chrom][0], p_len),
            _arm_background_cn(arm_segs[chrom][1], q_len),
        )

    # Pass 3: per-run re-threshold + gap-merge + min-size filter.
    seeds: List[tuple] = []
    for run in runs:
        chrom = run[-1].chrom
        cen_s, cen_e = arms[chrom]["cen"]
        total_len = sum(s.end - s.start for s in run)
        cutoff = cfg.gain if total_len <= cfg.max_seed_size else 1.2 * cfg.gain
        if run[-1].end <= cen_s:          # run sits on the p arm
            cutoff += arm_cn[chrom][0] - 2.0
        elif run[0].start >= cen_e:       # run sits on the q arm
            cutoff += arm_cn[chrom][1] - 2.0
        else:
            raise SeedError(
                f"amplified run spans the centromere on {chrom}: "
                f"{run[0].start}-{run[-1].end}"
            )
        kept = [s for s in run if s.cn >= cutoff]
        if not kept:
            continue
        # Gap-merge with the reference's exact accumulator semantics
        # (ref :113-128): acc resets to 0 after an emit, and a distant
        # segment with a still-short accumulated run is dropped.
        last: Optional[list] = None
        acc = 0
        for s in kept:
            if last is not None and s.start - last[2] <= cfg.max_seg_gap:
                acc += s.end - s.start
                last[2] = s.end
            elif last is None:
                last = [s.chrom, s.start, s.end]
                acc = s.end - s.start
            elif acc >= cfg.min_seed_size:
                seeds.append((last[0], last[1], last[2] - 1))
                acc = 0
                last = [s.chrom, s.start, s.end]
        if last is not None and acc >= cfg.min_seed_size:
            seeds.append((last[0], last[1], last[2] - 1))
    return seeds


def run_seeding(
    cn_seg_path: str,
    out_path: str = "",
    cfg: SeedConfig = SeedConfig(),
) -> str:
    """File->file seed mode (reference ``run_seeding``, ``src/cnv_seed.py:18``)."""
    segments = read_cn_segments(cn_seg_path)
    seeds = find_seeds(segments, cfg)
    out = out_path or cn_seg_path.replace(".cns", "_CNV_SEEDS.bed")
    with open(out, "w") as fp:
        for chrom, start, end in seeds:
            fp.write(f"{chrom}\t{start}\t{end}\n")
    logger.info("wrote %d seed intervals to %s", len(seeds), out)
    print("Created " + out)
    return out
