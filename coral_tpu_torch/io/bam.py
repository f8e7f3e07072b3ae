"""BAM reading: one streaming scan into flat numpy arrays + region queries.

This module replaces the reference's pysam/htslib usage
(``src/infer_breakpoint_graph.py:139-174`` fetch loop, ``count_coverage``
call sites at ``:131,1033-1034``, per-interval fetches at ``:721-802,
1306``).  Design differences from the reference, deliberately TPU-first:

* ONE sequential decode of the BAM populates a structure-of-arrays record
  table (flag/ref/pos/end/mapq/qlen/NM/SA-tag), so every downstream "fetch"
  is a vectorized binary search over sorted arrays instead of an htslib
  iterator;
* coverage sums are exact aligned-base overlap integrals computed by
  re-parsing only the records in the queried region (CIGAR M/=/X runs),
  matching ``pysam.count_coverage`` semantics including base-quality
  thresholds and flag filters;
* the heavy decode path has a native C++ backend (``coral_tpu/native``)
  with this pure-Python implementation as the reference oracle/fallback.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..tracing import count, span
from .bgzf import iter_blocks

# CIGAR op codes
_REF_CONSUMING = (1 << 0) | (1 << 2) | (1 << 3) | (1 << 7) | (1 << 8)   # M D N = X
_QRY_CONSUMING = (1 << 0) | (1 << 1) | (1 << 4) | (1 << 7) | (1 << 8)   # M I S = X
_ALIGNED = (1 << 0) | (1 << 7) | (1 << 8)                               # M = X

# pysam read_callback='all' exclusion mask (UNMAP|SECONDARY|QCFAIL|DUP)
FLAG_EXCLUDE_ALL = 0x704


@dataclass
class DecodedRecord:
    """Fully decoded alignment record (region queries only)."""
    index: int
    name: str
    flag: int
    ref_id: int
    pos: int
    end: int
    mapq: int
    cigar: List[Tuple[int, int]]        # (op, len)
    quals: Optional[np.ndarray]         # uint8 per base, None if absent

    def aligned_runs(self) -> Iterator[Tuple[int, int, int]]:
        """Yield (ref_start, length, query_start) for M/=/X runs."""
        rpos, qpos = self.pos, 0
        for op, n in self.cigar:
            if (1 << op) & _ALIGNED:
                yield rpos, n, qpos
                rpos += n
                qpos += n
            elif (1 << op) & _REF_CONSUMING:
                rpos += n
            elif (1 << op) & _QRY_CONSUMING:
                qpos += n

    def blocks(self) -> List[Tuple[int, int]]:
        """Aligned gapless blocks, split at D/N (pysam ``get_blocks``)."""
        out: List[Tuple[int, int]] = []
        rpos = self.pos
        for op, n in self.cigar:
            if (1 << op) & _ALIGNED:
                out.append((rpos, rpos + n))
                rpos += n
            elif (1 << op) & _REF_CONSUMING:
                rpos += n
        return out


class BamScanError(ValueError):
    pass


def _parse_aux_nm_sa(buf: memoryview, p: int, end: int) -> Tuple[int, Optional[bytes]]:
    """Scan aux fields for NM (int) and SA (Z). Returns (nm, sa_bytes)."""
    nm = 0
    sa = None
    while p < end:
        tag = bytes(buf[p:p + 2])
        typ = buf[p + 2]
        p += 3
        if typ in (0x63, 0x43, 0x41):          # 'c','C','A'
            if tag == b"NM":
                nm = buf[p] if typ != 0x63 else struct.unpack_from("<b", buf, p)[0]
            p += 1
        elif typ in (0x73, 0x53):              # 's','S'
            if tag == b"NM":
                nm = struct.unpack_from("<h" if typ == 0x73 else "<H", buf, p)[0]
            p += 2
        elif typ in (0x69, 0x49, 0x66):        # 'i','I','f'
            if tag == b"NM" and typ != 0x66:
                nm = struct.unpack_from("<i" if typ == 0x69 else "<I", buf, p)[0]
            p += 4
        elif typ in (0x5A, 0x48):              # 'Z','H'
            q = p
            while buf[q] != 0:
                q += 1
            if tag == b"SA":
                sa = bytes(buf[p:q])
            p = q + 1
        elif typ == 0x42:                      # 'B'
            sub = buf[p]
            cnt = struct.unpack_from("<I", buf, p + 1)[0]
            size = {0x63: 1, 0x43: 1, 0x73: 2, 0x53: 2, 0x69: 4, 0x49: 4, 0x66: 4}[sub]
            p += 5 + cnt * size
        else:
            raise BamScanError(f"unknown aux type {typ:#x} for tag {tag!r}")
    return nm, sa


class BamFile:
    """In-memory record table over a coordinate-sorted BAM.

    Attributes (length-n numpy arrays): ``flag`` u16, ``ref_id`` i32,
    ``pos``/``end`` i64, ``mapq`` u8, ``qlen`` i32 (SEQ length), ``nm`` i64.
    SA tags live in a byte blob addressed by ``sa_off``/``sa_len``; read
    names in ``name_blob`` addressed by ``name_off``.
    """

    def __init__(self, path: str, backend: str = "auto",
                 scan_cache: bool = False):
        """``scan_cache=True`` persists the scanned record table to
        ``<path>.scanx`` and re-opens from it instantly while the BAM's
        (size, mtime) are unchanged — the scan-resume stage checkpoint
        (no reference analog; the reference re-scans on every run).
        Native backend only; the python backend ignores it."""
        self.path = path
        if backend == "auto":
            backend = "native" if _native_available() else "python"
        self.backend = backend
        self.scan_from_cache = False
        if backend == "native":
            from ..native import bamcore
            bamcore.scan_into(self, path,
                              path + ".scanx" if scan_cache else None)
        else:
            self._scan_python(path)
        self._build_index()
        self._names: Optional[List[str]] = None
        self._rid_map: Optional[Dict[str, int]] = None

    # -- scanning ---------------------------------------------------------

    def _scan_python(self, path: str) -> None:
        with open(path, "rb") as fp:
            raw = fp.read()
        payload_parts = []
        for _, block in iter_blocks(raw):
            payload_parts.append(block)
        payload = b"".join(payload_parts)
        if payload[:4] != b"BAM\x01":
            raise BamScanError(f"{path}: not a BAM file")
        buf = memoryview(payload)
        l_text = struct.unpack_from("<i", buf, 4)[0]
        p = 8 + l_text
        n_ref = struct.unpack_from("<i", buf, p)[0]
        p += 4
        refs: List[Tuple[str, int]] = []
        for _ in range(n_ref):
            l_name = struct.unpack_from("<i", buf, p)[0]
            name = bytes(buf[p + 4: p + 4 + l_name - 1]).decode()
            l_ref = struct.unpack_from("<i", buf, p + 4 + l_name)[0]
            refs.append((name, l_ref))
            p += 8 + l_name
        self.references = refs

        flags, ref_ids, poss, ends, mapqs, qlens, nms, upos_list = \
            [], [], [], [], [], [], [], []
        name_blob = bytearray()
        name_off = [0]
        sa_blob = bytearray()
        sa_off, sa_len = [], []
        n_total = len(payload)
        while p < n_total:
            block_size = struct.unpack_from("<i", buf, p)[0]
            rec_start = p
            p += 4
            (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag,
             l_seq, _nref, _npos, _tlen) = struct.unpack_from("<iiBBHHHiiii", buf, p)
            p += 32
            name_blob += bytes(buf[p:p + l_read_name - 1])
            name_off.append(len(name_blob))
            p += l_read_name
            ref_len = 0
            for ci in range(n_cigar):
                c = struct.unpack_from("<I", buf, p + 4 * ci)[0]
                if (1 << (c & 0xF)) & _REF_CONSUMING:
                    ref_len += c >> 4
            p += 4 * n_cigar
            p += (l_seq + 1) // 2 + l_seq
            aux_end = rec_start + 4 + block_size
            nm, sa = _parse_aux_nm_sa(buf, p, aux_end)
            p = aux_end
            flags.append(flag)
            ref_ids.append(ref_id)
            poss.append(pos)
            ends.append(pos + ref_len)
            mapqs.append(mapq)
            qlens.append(l_seq)
            nms.append(nm)
            upos_list.append(rec_start)
            if sa is not None:
                sa_off.append(len(sa_blob))
                sa_len.append(len(sa))
                sa_blob += sa
            else:
                sa_off.append(0)
                sa_len.append(0)

        self.n_records = len(flags)
        self.flag = np.asarray(flags, np.uint16)
        self.ref_id = np.asarray(ref_ids, np.int32)
        self.pos = np.asarray(poss, np.int64)
        self.end = np.asarray(ends, np.int64)
        self.mapq = np.asarray(mapqs, np.uint8)
        self.qlen = np.asarray(qlens, np.int32)
        self.nm = np.asarray(nms, np.int64)
        self.name_blob = bytes(name_blob)
        self.name_off = np.asarray(name_off, np.int64)
        self.sa_blob = bytes(sa_blob)
        self.sa_off = np.asarray(sa_off, np.int64)
        self.sa_len = np.asarray(sa_len, np.int64)
        self._payload = payload
        self._upos = np.asarray(upos_list, np.int64)

    # -- index + basic queries -------------------------------------------

    def _build_index(self) -> None:
        # records must be coordinate-sorted (grouped by ref, ascending pos)
        self._ref_slices: Dict[int, Tuple[int, int]] = {}
        self._cummax_end: np.ndarray = np.zeros(self.n_records, np.int64)
        if self.n_records == 0:
            return
        rid = self.ref_id
        bounds = np.flatnonzero(np.diff(rid)) + 1
        starts = np.concatenate([[0], bounds])
        stops = np.concatenate([bounds, [self.n_records]])
        for s, e in zip(starts, stops):
            r = int(rid[s])
            if r in self._ref_slices:
                raise BamScanError("BAM is not coordinate-sorted (ref groups split)")
            if r >= 0:
                self._ref_slices[r] = (int(s), int(e))
            if np.any(np.diff(self.pos[s:e]) < 0):
                raise BamScanError("BAM is not coordinate-sorted (positions)")
            self._cummax_end[s:e] = np.maximum.accumulate(self.end[s:e])

    def rid(self, chrom: str) -> int:
        # every region query calls this; a linear scan over the reference
        # list is O(n_refs) per query on scaffold-heavy assemblies
        if self._rid_map is None:
            self._rid_map = {name: i
                             for i, (name, _l) in enumerate(self.references)}
        return self._rid_map.get(chrom, -1)

    def name(self, i: int) -> str:
        # latin-1, matching names_at(): SAM names are ASCII where the
        # two decodings agree; on out-of-spec bytes a mixed decode would
        # split one read across two dict keys
        return self.name_blob[self.name_off[i]:self.name_off[i + 1]] \
            .decode("latin-1")

    def names(self) -> List[str]:
        if self._names is None:
            self._names = self.names_at(np.arange(self.n_records))
        return self._names

    def names_at(self, idx) -> List[str]:
        """Bulk name decode for an index array: one memoized whole-blob
        decode + str slicing (~5x cheaper than per-record ``name()``
        calls — ChimeraStore builds 1.5M names at WGS junction counts).
        latin-1 keeps byte offsets valid; SAM names are ASCII so values
        match ``name()``'s utf-8."""
        if getattr(self, "_name_str", None) is None:
            self._name_str = self.name_blob.decode("latin-1")
        blob = self._name_str
        off = self.name_off
        i = np.asarray(idx, np.int64)
        lo = off[i].tolist()
        hi = off[i + 1].tolist()
        return [blob[a:b] for a, b in zip(lo, hi)]

    def sa_tag(self, i: int) -> Optional[str]:
        if self.sa_len[i] == 0:
            return None
        o = self.sa_off[i]
        return self.sa_blob[o:o + self.sa_len[i]].decode()

    def overlap_range(self, chrom: str, start: int, stop: int) -> Tuple[int, int]:
        """Candidate table-index range [lo, hi) for records overlapping
        [start, stop); callers must still filter ``end > start``."""
        r = self.rid(chrom)
        if r < 0 or r not in self._ref_slices:
            return (0, 0)
        s, e = self._ref_slices[r]
        hi = s + int(np.searchsorted(self.pos[s:e], stop, side="left"))
        lo = s + int(np.searchsorted(self._cummax_end[s:hi], start, side="right"))
        return (lo, hi)

    def overlap(self, chrom: str, start: int, stop: int) -> np.ndarray:
        """Indices of records overlapping [start, stop) (pysam ``fetch``)."""
        lo, hi = self.overlap_range(chrom, start, stop)
        idx = np.arange(lo, hi)
        return idx[self.end[lo:hi] > start]

    def overlap_rows(self, chrom: str, start: int, stop: int):
        """Iterable of candidate table-row indices for records overlapping
        [start, stop), in coordinate order (callers still filter
        ``end > start``).  Single-file: one contiguous range; the
        multi-shard view (``parallel.multihost.MultiShardBam``) chains
        per-shard ranges with global offsets."""
        lo, hi = self.overlap_range(chrom, start, stop)
        return range(lo, hi)

    def region_records(self, chrom: str, start: int, stop: int):
        """Candidate (pos, end, mapq, name_bytes) rows overlapping
        [start, stop), in row order (callers still filter ``end > start``).

        The narrow record surface the reconstruct stages consume, so every
        BAM view can implement it: single file (here), multi-shard
        concatenation in shard order (``parallel.multihost.MultiShardBam``)
        and cross-process gather in process order
        (``parallel.distributed.DistributedShardBam``)."""
        lo, hi = self.overlap_range(chrom, start, stop)
        off = self.name_off
        blob = self.name_blob
        for i in range(lo, hi):
            yield (int(self.pos[i]), int(self.end[i]), int(self.mapq[i]),
                   bytes(blob[int(off[i]):int(off[i + 1])]))

    # -- region decode ----------------------------------------------------

    def decode_region(self, chrom: str, start: int, stop: int) -> Iterator[DecodedRecord]:
        """Fully decode records overlapping [start, stop) (python backend)."""
        idx = self.overlap(chrom, start, stop)
        buf = memoryview(self._payload)
        for i in idx:
            yield self._decode_at(buf, int(i))

    def _decode_at(self, buf: memoryview, i: int) -> DecodedRecord:
        p = int(self._upos[i])
        block_size = struct.unpack_from("<i", buf, p)[0]
        p += 4
        (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag,
         l_seq, _nr, _np, _tl) = struct.unpack_from("<iiBBHHHiiii", buf, p)
        p += 32
        name = bytes(buf[p:p + l_read_name - 1]).decode()
        p += l_read_name
        cigar = []
        for ci in range(n_cigar):
            c = struct.unpack_from("<I", buf, p + 4 * ci)[0]
            cigar.append((c & 0xF, c >> 4))
        p += 4 * n_cigar
        p += (l_seq + 1) // 2
        quals = None
        if l_seq:
            q = np.frombuffer(buf, np.uint8, l_seq, p)
            quals = None if q[0] == 0xFF else q
        return DecodedRecord(i, name, flag, ref_id, pos, int(self.end[i]),
                             mapq, cigar, quals)

    # -- pysam-equivalent aggregates -------------------------------------

    def coverage_sum(
        self, chrom: str, start: int, stop: int,
        quality_threshold: int = 0,
        flag_exclude: int = 0,
        min_mapq: int = 0,
    ) -> int:
        """Total aligned-base count over [start, stop).

        Equals ``sum(sum(x) for x in pysam.count_coverage(...))`` with the
        given base-quality threshold and flag filter
        (reference call sites: ``infer_breakpoint_graph.py:131,1033``).
        """
        if self.backend == "native":
            from ..native import bamcore
            lo, hi = self.overlap_range(chrom, start, stop)
            with span("decode.coverage_sum"):
                return bamcore.coverage_sum(
                    self, lo, hi, start, stop, quality_threshold,
                    flag_exclude, min_mapq)
        total = 0
        for rec in self.decode_region(chrom, start, stop):
            if rec.flag & flag_exclude or rec.mapq < min_mapq:
                continue
            for rs, n, qs in rec.aligned_runs():
                lo = max(rs, start)
                hi = min(rs + n, stop)
                if hi <= lo:
                    continue
                if quality_threshold > 0 and rec.quals is not None:
                    qseg = rec.quals[qs + (lo - rs): qs + (hi - rs)]
                    total += int(np.count_nonzero(qseg >= quality_threshold))
                else:
                    total += hi - lo
        return total

    def coverage_profile(
        self, chrom: str, start: int, stop: int,
        quality_threshold: int = 0,
        flag_exclude: int = 0,
        min_mapq: int = 0,
    ) -> np.ndarray:
        """Per-position aligned-base coverage over [start, stop)."""
        if self.backend == "native":
            from ..native import bamcore
            lo, hi = self.overlap_range(chrom, start, stop)
            with span("decode.coverage_profile"):
                return bamcore.coverage_profile(
                    self, lo, hi, start, stop, quality_threshold,
                    flag_exclude, min_mapq)
        out = np.zeros(stop - start, np.int64)
        for rec in self.decode_region(chrom, start, stop):
            if rec.flag & flag_exclude or rec.mapq < min_mapq:
                continue
            for rs, n, qs in rec.aligned_runs():
                lo = max(rs, start)
                hi = min(rs + n, stop)
                if hi <= lo:
                    continue
                if quality_threshold > 0 and rec.quals is not None:
                    qseg = rec.quals[qs + (lo - rs): qs + (hi - rs)]
                    out[lo - start: hi - start] += (qseg >= quality_threshold)
                else:
                    out[lo - start: hi - start] += 1
        return out

    def read_count(self, chrom: str, start: int, stop: int) -> int:
        """Number of records overlapping [start, stop) — pysam fetch count
        (reference ``assign_cov``, ``infer_breakpoint_graph.py:1031-1032``)."""
        return int(self.overlap(chrom, start, stop).size)

    def names_overlapping(self, chrom: str, start: int, stop: int) -> set:
        """Set of read names of records overlapping [start, stop)."""
        return set(self.names_at(self.overlap(chrom, start, stop)))

    def del_gap_alignments(
        self, chrom: str, start: int, stop: int,
        min_del_len: int, min_mapq: int = 20,
    ) -> List[tuple]:
        """Large CIGAR deletion gaps per record in [start, stop).

        Returns (name, mapq, gaps, ref_start, ref_end, nm, qlen) per record
        having >= 1 block gap > min_del_len, where gaps is a list of
        (next_block_start, prev_block_end).  Mirrors the blocks-walk of
        ``find_smalldel_breakpoints`` (``infer_breakpoint_graph.py:721-802``).
        """
        if self.backend == "native":
            from ..native import bamcore
            lo, hi = self.overlap_range(chrom, start, stop)
            with span("decode.del_gaps"):
                rec, nxt, prv, bf, bl = bamcore.del_gaps(
                    self, lo, hi, start, min_del_len, min_mapq)
            out = []
            k = 0
            while k < rec.size:
                i = int(rec[k])
                gaps = []
                while k < rec.size and rec[k] == i:
                    gaps.append((int(nxt[k]), int(prv[k])))
                    k += 1
                out.append((self.name(i), int(self.mapq[i]), gaps,
                            int(bf[k - 1]), int(bl[k - 1]),
                            int(self.nm[i]), int(self.qlen[i])))
            count("del_gap_alignments", len(out))
            return out
        out = []
        for rec in self.decode_region(chrom, start, stop):
            if rec.mapq < min_mapq:
                continue
            blocks = rec.blocks()
            gaps = [
                (blocks[bi + 1][0], blocks[bi][1])
                for bi in range(len(blocks) - 1)
                if abs(blocks[bi + 1][0] - blocks[bi][1]) > min_del_len
            ]
            if gaps:
                out.append((rec.name, rec.mapq, gaps,
                            blocks[0][0], blocks[-1][1],
                            int(self.nm[rec.index]), int(self.qlen[rec.index])))
        count("del_gap_alignments", len(out))
        return out

    def close(self) -> None:
        self._payload = b""


def _native_available() -> bool:
    from ..native import _build

    try:
        _build.build("bamcore")
    except OSError:
        return False
    return True
