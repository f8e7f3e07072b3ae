"""SA-tag (supplementary alignment) decoding into chimeric alignments.

Replaces the reference's nine closed-form CIGAR-shape decoders
(``src/cigar_parsing.py:17-229``) with one generic formula over
(left_clip, M+D ref span, right_clip):

    al       = sum(M) + sum(D)                 # reference span
    qs('+')  = left_clip
    qe('+')  = read_length - right_clip - 1
    qs('-')  = right_clip
    qe('-')  = read_length - left_clip - 1

which reproduces every one of the reference's SM/MS/SMS/SMD/MDS/SMDS/SMI/
MIS/SMIS cases exactly (verified in tests against all nine formulas) and
extends to arbitrary single-segment CIGARs.  A chimeric alignment is the
set of local alignments of one read, sorted by query start
(``cigar_parsing.py:232-269``).
"""
from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..tracing import span

logger = logging.getLogger(__name__)

_CIG_RE = re.compile(r"(\d+)([A-Z=])")


def sa_cigar_spans(cigar: str) -> Tuple[int, int, int, int]:
    """(left_clip, ref_span, right_clip, query_span_total) of a CIGAR."""
    left = right = ref = qtot = 0
    seen_core = False
    for m in _CIG_RE.finditer(cigar):
        n, op = int(m.group(1)), m.group(2)
        if op in "SH":
            if seen_core:
                right += n
            else:
                left += n
            qtot += n
        else:
            seen_core = True
            if op in "MDN=X":
                if op in "M=X":
                    ref += n
                    qtot += n
                else:
                    ref += n
            elif op == "I":
                qtot += n
    return left, ref, right, qtot


@dataclass
class Chimera:
    """One read's chimeric alignment, sorted by query start.

    Mirrors the (qint, rint, qual, nm) tuple of the reference: ``q`` holds
    [qs, qe] on the forward-oriented read; ``r`` holds [chrom, a, b, strand]
    where a > b for '-' strand (the reference's storage convention,
    ``cigar_parsing.py:258-260``); ``nm`` is per-aligned-base.
    """
    q: List[List[int]]
    r: List[list]
    mapq: List[int]
    nm: List[float]

    def __len__(self):
        return len(self.q)


def alignment_from_sa(sa_entries: List[str], read_length: int) -> Optional[Chimera]:
    """Decode a list of ``SA:Z`` records into a Chimera.

    Returns None when any record lacks both a clip and a match, matching the
    reference's whole-read discard (``cigar_parsing.py:248-253``).
    """
    q, r, mapq, nm = [], [], [], []
    for sa in sa_entries:
        f = sa.split(",")
        cigar = f[3]
        if "S" not in cigar or "M" not in cigar:
            logger.warning("chimeric alignment without match or soft clips: %s", sa_entries)
            return None
        left, al, right, _ = sa_cigar_spans(cigar)
        strand = f[2]
        if strand == "+":
            qs, qe = left, read_length - right - 1
        else:
            qs, qe = right, read_length - left - 1
        pos1 = int(f[1])  # 1-based leftmost
        q.append([qs, qe])
        if strand == "+":
            r.append([f[0], pos1 - 1, pos1 + al - 2, "+"])
        else:
            r.append([f[0], pos1 + al - 2, pos1 - 1, "-"])
        mapq.append(int(f[4]))
        nm.append(float(f[-1]))
    order = sorted(range(len(q)), key=lambda i: (q[i][0], q[i][1]))
    q = [q[i] for i in order]
    r = [r[i] for i in order]
    mapq = [mapq[i] for i in order]
    nm = [nm[i] for i in order]
    # a degenerate 1-base local alignment has qe == qs (the reference's
    # off-by-one span) and ZeroDivisionErrors in the reference
    # (cigar_parsing.py:268); crash-fix policy: emit inf per-base NM like
    # the native backend (bamcore.cpp float division) so host == native
    nm = [nm[i] / span if (span := q[i][1] - q[i][0]) else float("inf")
          for i in range(len(nm))]
    return Chimera(q, r, mapq, nm)


class ChimeraStore(dict):
    """Lazy chimera dictionary over the native flat alignment table.

    Behaves as {read_name: Chimera} (materializing Chimera objects on
    first access) while exposing the flat structure-of-arrays columns for
    the device scoring path so whole-table kernels never touch Python
    objects.
    """

    def __init__(self, bam, chim_rec, chim_off, cols):
        super().__init__()
        self._bam = bam
        self.chim_off = chim_off
        self.cols = cols
        self.names = (bam.names_at(chim_rec) if hasattr(bam, "names_at")
                      else [bam.name(int(i)) for i in chim_rec])
        self._ref_names = [r[0] for r in bam.references]
        self._table = None
        # name -> slot dict and the numpy name array are built lazily:
        # at WGS junction counts (~1.5M chimeric reads) each costs
        # hundreds of ms, and slot-indexed paths (the segment-index
        # interval search, the whole-table scorer) never need the dict
        self._slot_map = None
        self._names_np = None

    @property
    def _slot(self):
        if self._slot_map is None:
            # dict(zip(...)) builds at C speed (~4x a dict comprehension
            # at this size)
            self._slot_map = dict(zip(self.names, range(len(self.names))))
        return self._slot_map

    def names_array(self) -> "np.ndarray":
        """Memoized numpy (unicode) view of ``names`` for vectorized
        canonical-order sorts (lexicographic order equals python
        ``sorted`` on the ASCII read names the BAM spec allows)."""
        if self._names_np is None:
            self._names_np = np.asarray(self.names)
        return self._names_np

    def flat_table(self):
        """Memoized whole-store ChimeraTable for batch scoring."""
        if self._table is None:
            from .pairs import build_chimera_table
            self._table = build_chimera_table(self)
        return self._table

    def __len__(self):
        return len(self.names)

    def __iter__(self):
        return iter(self.names)

    def __contains__(self, rn):
        return rn in self._slot

    def keys(self):
        return self.names

    def items(self):
        return ((rn, self[rn]) for rn in self.names)

    def values(self):
        return (self[rn] for rn in self.names)

    def light_qr(self, rn):
        """(q, r) alignment lists for one read built straight off the
        flat columns — no Chimera construction and NO caching.  The
        path-constraint pass touches every breakpoint-supporting read
        once; materializing (and caching) a Python Chimera per read was
        a top profile entry and a ~1 KB/read memory tax at WGS junction
        counts."""
        if super().__contains__(rn):
            chim = super().__getitem__(rn)
            return chim.q, chim.r
        k = self._slot[rn]
        lo, hi = int(self.chim_off[k]), int(self.chim_off[k + 1])
        qs, qe, ref, r1, r2, strand, mapq, nm = self.cols
        q, r = [], []
        for i in range(lo, hi):
            q.append([int(qs[i]), int(qe[i])])
            name = self._ref_names[ref[i]] if ref[i] >= 0 else "?"
            r.append([name, int(r1[i]), int(r2[i]),
                      "+" if strand[i] > 0 else "-"])
        return q, r

    def __getitem__(self, rn):
        if super().__contains__(rn):
            return super().__getitem__(rn)
        return self.chimera_at(self._slot[rn], rn)

    def chimera_at(self, k: int, rn=None):
        """Chimera by SLOT index — no name->slot dict needed (callers
        that already hold slots keep the lazy dict unbuilt)."""
        rn = self.names[k] if rn is None else rn
        if super().__contains__(rn):
            return super().__getitem__(rn)
        lo, hi = int(self.chim_off[k]), int(self.chim_off[k + 1])
        qs, qe, ref, r1, r2, strand, mapq, nm = self.cols
        q, r = [], []
        for i in range(lo, hi):
            q.append([int(qs[i]), int(qe[i])])
            name = self._ref_names[ref[i]] if ref[i] >= 0 else "?"
            r.append([name, int(r1[i]), int(r2[i]),
                      "+" if strand[i] > 0 else "-"])
        chim = Chimera(q, r, [int(m) for m in mapq[lo:hi]],
                       [float(x) for x in nm[lo:hi]])
        super().__setitem__(rn, chim)
        return chim


def collect_chimeras(bam) -> Tuple[dict, dict, list]:
    """Whole-BAM chimera collection (reference ``fetch``,
    ``infer_breakpoint_graph.py:139-174``).

    Returns (read_length, chimeras, nm_stats):
      read_length: name -> query length of the primary record
      chimeras:    name -> Chimera (reads with SA tags and a primary record)
      nm_stats:    [mean, std, count] of per-base NM over mapq-60 records
                   without SA tags (the reference's edit-distance baseline).
    """
    import math

    import numpy as np

    has_sa = bam.sa_len > 0
    primary = bam.flag < 256

    # NM baseline over confident non-chimeric records (shared by both paths)
    def _nm_baseline():
        nm_idx = np.flatnonzero((~has_sa) & (bam.mapq == 60) & (bam.qlen > 0))
        if not nm_idx.size:
            return [0.0, 0.0, 0]
        e = bam.nm[nm_idx] / bam.qlen[nm_idx]
        mean = float(np.mean(e))
        std = float(math.sqrt(max(float(np.mean(e * e)) - mean * mean, 0.0)))
        return [mean, std, int(nm_idx.size)]

    if bam.backend == "native":
        from ..native import bamcore
        with span("chimera.parse_sa"):
            chim_rec, chim_rl, chim_off, cols = bamcore.parse_sa(bam)
        store = ChimeraStore(bam, chim_rec, chim_off, cols)
        # read lengths only needed for chimeric reads downstream; the
        # native scan already collected them.  dict(zip(...)) over
        # tolist() builds at C speed — the per-entry int() comprehension
        # cost ~0.9 s alone at 1.5M chimeric reads (round-5 profile)
        read_length = dict(zip(store.names,
                               np.asarray(chim_rl).tolist()))
        logger.info("collected %d chimeric reads (native)", len(store))
        return read_length, store, _nm_baseline()

    read_length = {}
    sa_lists = {}
    names = bam.names()
    # read lengths from the first primary record per name
    for i in np.flatnonzero(primary):
        rn = names[i]
        if rn not in read_length:
            read_length[rn] = int(bam.qlen[i])
    # SA union per read (each record's SA lists the read's other alignments)
    for i in np.flatnonzero(has_sa):
        rn = names[i]
        tag = bam.sa_tag(int(i))
        entries = tag[:-1].split(";") if tag.endswith(";") else tag.split(";")
        bucket = sa_lists.setdefault(rn, [])
        for sa in entries:
            if sa and sa not in bucket:
                bucket.append(sa)
    nm_stats = _nm_baseline()
    chimeras = {}
    for rn, entries in sa_lists.items():
        if rn not in read_length:
            logger.warning("chimeric read without primary alignment: %s", rn)
            continue
        chim = alignment_from_sa(entries, read_length[rn])
        # a malformed SA set keeps the read with an empty chimera, matching
        # the reference's ([], [], []) sentinel (cigar_parsing.py:253)
        chimeras[rn] = chim if chim is not None else Chimera([], [], [], [])
    logger.info("collected %d chimeric reads", len(chimeras))
    return read_length, chimeras, nm_stats
