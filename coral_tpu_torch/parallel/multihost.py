"""Multi-process / multi-host BAM-shard ingest with deterministic merge.

SURVEY §2.1 / §5 "Distributed communication backend": the reference has no
distribution of any kind; the TPU build's model of record is per-host BAM
shard ingest with deterministic integer reductions so that N hosts produce
byte-identical outputs to one.  This module is that host-sharding entry
point:

* :func:`split_bam` — partition a coordinate-sorted BAM into N shard
  files preserving global record order (shard k holds the k-th contiguous
  slice), the layout a multi-host deployment would stage per host;
* :func:`scan_shard` — the per-process worker: scans one shard and
  returns its raw ingest products (read lengths, SA buckets in record
  order, NM moment sums) — everything downstream of the scan is exactly
  the single-process code;
* :class:`MultiShardBam` — a BamFile-compatible view over the shard set
  whose region queries reduce deterministically across shards (integer
  sums for coverage, order-preserving concatenation for record rows);
* :func:`multihost_reconstruct_graphs` — end-to-end graph reconstruction
  with the whole-BAM scan fanned out over a process pool.

Determinism argument: the single-process scan visits records in file
order; shard k is the k-th contiguous slice of that order, so merging
per-shard products in shard order reproduces the single-process iteration
order exactly (dict insertion order included), and all cross-shard
reductions are integer sums or order-preserving concatenations.  The one
float exception is the NM baseline (mean/std of per-base NM): it is
merged from per-shard moment sums, which can differ from the fused
single-pass result in the last ulp; it only gates the optional
``--filter_bp_by_edit_distance`` path.  Everything that feeds graph.txt /
cycles.txt is bit-identical — ``tests/test_torch_multihost.py`` asserts
byte-identical output files for 1/2/3-process runs.

In a true multi-host deployment the same worker runs under
``torch.distributed`` with one process per host
(:mod:`coral_tpu_torch.parallel.distributed`) and the merge travels over
the group's collectives; the merge math is identical, which is what these
tests pin.  This module is the port's copy of
``coral_tpu/parallel/multihost.py``; only
:func:`multihost_reconstruct_graphs` differs, by its ``device``.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..io.bam import BamFile
from ..io.bgzf import BGZF_EOF, write_bgzf


# --------------------------------------------------------------------------
# BAM splitting (per-host shard staging)
# --------------------------------------------------------------------------

def _iter_payload(path: str):
    """Stream a BGZF file's decompressed payload block by block in O(1)
    memory (BGZF members are <= 64 KiB, so a small rolling compressed
    buffer always holds at least one complete member)."""
    from ..io.bgzf import read_block_at

    with open(path, "rb") as fp:
        buf = b""
        off = 0
        while True:
            if len(buf) - off < (1 << 17):
                chunk = fp.read(1 << 22)
                buf = buf[off:] + chunk
                off = 0
            if off >= len(buf):
                return
            payload, off = read_block_at(buf, off)
            if payload:
                yield payload


def _walk_bam(path: str):
    """Yield ('header', bytes) once, then ('record', bytes) per record,
    streaming with memory bounded by one record + one block."""
    buf = bytearray()
    chunks = _iter_payload(path)

    def need(n: int) -> bool:
        while len(buf) < n:
            try:
                buf.extend(next(chunks))
            except StopIteration:
                return False
        return True

    if not need(12) or bytes(buf[:4]) != b"BAM\x01":
        raise ValueError(f"{path}: not a BAM payload")
    (l_text,) = struct.unpack_from("<i", buf, 4)
    if not need(8 + l_text + 4):
        raise ValueError(f"{path}: truncated header")
    p = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", buf, p)
    p += 4
    for _ in range(n_ref):
        if not need(p + 4):
            raise ValueError(f"{path}: truncated reference table")
        (l_name,) = struct.unpack_from("<i", buf, p)
        if not need(p + 8 + l_name):
            raise ValueError(f"{path}: truncated reference table")
        p += 4 + l_name + 4
    yield ("header", bytes(buf[:p]))
    del buf[:p]
    while True:
        if not need(4):
            return
        (block_size,) = struct.unpack_from("<i", buf, 0)
        if not need(4 + block_size):
            raise ValueError(f"{path}: truncated record")
        yield ("record", bytes(buf[: 4 + block_size]))
        del buf[: 4 + block_size]


class _ShardWriter:
    """Buffered BGZF shard writer (~1 MiB deflate batches)."""

    def __init__(self, out_path: str, header: bytes):
        self._fp = open(out_path, "wb")
        self._buf = bytearray(header)

    def write(self, blob: bytes) -> None:
        self._buf.extend(blob)
        if len(self._buf) >= (1 << 20):
            self.flush()

    def flush(self) -> None:
        if self._buf:
            write_bgzf(self._fp, bytes(self._buf))
            self._buf.clear()

    def close(self) -> None:
        # idempotent: split_bam's finally-close must not mask an original
        # error (e.g. disk-full while opening the NEXT shard) by writing
        # the EOF marker to an already-closed file
        if self._fp.closed:
            return
        self.flush()
        self._fp.write(BGZF_EOF)
        self._fp.close()


def split_bam(path: str, out_paths: Sequence[str]) -> List[str]:
    """Split a BAM into ``len(out_paths)`` shards of contiguous records.

    Raw record blobs are copied verbatim (all tags preserved); every shard
    carries the full header, so each is a valid standalone BAM and their
    record-order concatenation equals the input.  Two streaming passes
    (count, then write) keep memory bounded by one record + one BGZF
    block — WGS-size inputs never materialize in RAM.
    """
    n = sum(1 for kind, _ in _walk_bam(path) if kind == "record")
    k = len(out_paths)
    bounds = [round(i * n / k) for i in range(k + 1)]
    walker = _walk_bam(path)
    kind, header = next(walker)
    assert kind == "header"
    sh = 0
    writer = _ShardWriter(out_paths[0], header)
    try:
        for i, (kind, blob) in enumerate(walker):
            while i >= bounds[sh + 1] and sh < k - 1:
                writer.close()
                sh += 1
                writer = _ShardWriter(out_paths[sh], header)
            writer.write(blob)
    finally:
        writer.close()
    # empty trailing shards still need valid headers
    for j in range(sh + 1, k):
        w = _ShardWriter(out_paths[j], header)
        w.close()
    return list(out_paths)


# --------------------------------------------------------------------------
# Per-process worker
# --------------------------------------------------------------------------

def scan_shard(shard_path: str) -> dict:
    """Scan one BAM shard; return its raw ingest products (picklable).

    Mirrors the bucket-building of ``ops.chimera.collect_chimeras`` but
    stops before SA decoding, because a read's supplementary records can
    land in a different shard than its primary: buckets must be merged
    across shards (in shard order) before decoding.
    """
    bam = BamFile(shard_path)
    try:
        primary = np.asarray(bam.flag) < 256
        has_sa = np.asarray(bam.sa_len) > 0
        # names are decoded ONLY for SA-bearing records: downstream needs
        # read lengths for chimeric reads alone (exactly what the native
        # single-process fast path collects, ops/chimera.py::collect_
        # chimeras), and decoding all 8-70M names in Python dominated the
        # shard scan (53 s -> ~8 s on the 8.66M-record WGS bench).
        read_length: Dict[str, int] = {}
        for i in np.flatnonzero(primary & has_sa):
            rn = bam.name(int(i))
            if rn not in read_length:
                read_length[rn] = int(bam.qlen[i])
        sa_buckets: Dict[str, List[str]] = {}
        for i in np.flatnonzero(has_sa):
            rn = bam.name(int(i))
            tag = bam.sa_tag(int(i))
            entries = tag[:-1].split(";") if tag.endswith(";") else tag.split(";")
            bucket = sa_buckets.setdefault(rn, [])
            for sa in entries:
                if sa and sa not in bucket:
                    bucket.append(sa)
        nm_idx = np.flatnonzero((~has_sa) & (np.asarray(bam.mapq) == 60)
                                & (np.asarray(bam.qlen) > 0))
        if nm_idx.size:
            e = np.asarray(bam.nm)[nm_idx] / np.asarray(bam.qlen)[nm_idx]
            nm_sums = (float(np.sum(e)), float(np.sum(e * e)), int(nm_idx.size))
        else:
            nm_sums = (0.0, 0.0, 0)
        return {"read_length": read_length, "sa_buckets": sa_buckets,
                "nm_sums": nm_sums}
    finally:
        bam.close()


def _rescue_read_lengths(shards, missing) -> Dict[str, int]:
    """Find primary-record read lengths for chimeric names whose primary
    does not itself carry an SA tag (so :func:`scan_shard`'s SA-only name
    decode missed it — possibly in a different shard than the
    supplementary).  Candidate records are screened vectorized on
    (length, first byte, last byte) so only near-matches are decoded."""
    found: Dict[str, int] = {}
    if not missing:
        return found
    groups: Dict[Tuple[int, int, int], List[bytes]] = {}
    for rn in missing:
        b = rn.encode()  # name_off spans exclude the NUL (io/bam.py:188)
        if b:
            groups.setdefault((len(b), b[0], b[-1]), []).append(b)
    for s in shards:
        off = np.asarray(s.name_off, np.int64)
        if off.size < 2 or not len(bytes(s.name_blob)):
            continue
        blob = np.frombuffer(bytes(s.name_blob), np.uint8)
        lengths = np.diff(off)
        first = blob[np.minimum(off[:-1], len(blob) - 1)]
        last = blob[np.maximum(off[1:] - 1, off[:-1])]
        primary = np.asarray(s.flag) < 256
        for (ln, f0, lb), names in groups.items():
            cand = np.flatnonzero(primary & (lengths == ln)
                                  & (first == f0) & (last == lb))
            for i in cand:
                raw = bytes(blob[off[i]:off[i + 1]])
                for b in names:
                    if raw == b:
                        rn = b.decode()
                        if rn not in found:
                            found[rn] = int(s.qlen[i])
    return found


def merge_scan_parts(parts: List[dict]):
    """Merge per-shard scan products in shard order (phase 1 of
    :func:`merge_scan_products`): read lengths keep the first-seen
    primary, SA buckets append across shards with in-order dedup, the NM
    baseline merges moment sums.  Returns (read_length, sa_buckets,
    nm_stats)."""
    import math

    read_length: Dict[str, int] = {}
    sa_buckets: Dict[str, List[str]] = {}
    s1 = s2 = 0.0
    n = 0
    for part in parts:
        for rn, ql in part["read_length"].items():
            if rn not in read_length:
                read_length[rn] = ql
        for rn, entries in part["sa_buckets"].items():
            bucket = sa_buckets.setdefault(rn, [])
            for sa in entries:
                if sa not in bucket:
                    bucket.append(sa)
        a, b, c = part["nm_sums"]
        s1 += a
        s2 += b
        n += c
    if n:
        mean = s1 / n
        nm_stats = [mean, math.sqrt(max(s2 / n - mean * mean, 0.0)), n]
    else:
        nm_stats = [0.0, 0.0, 0]
    return read_length, sa_buckets, nm_stats


def decode_chimeras(read_length: Dict[str, int],
                    sa_buckets: Dict[str, List[str]]):
    """Phase 2 of :func:`merge_scan_products`: decode every SA bucket
    whose read has a known primary length (names without any primary are
    dropped, matching both single-process paths)."""
    from ..ops.chimera import Chimera, alignment_from_sa

    chimeras: Dict[str, Chimera] = {}
    for rn, entries in sa_buckets.items():
        if rn not in read_length:
            continue
        chim = alignment_from_sa(entries, read_length[rn])
        chimeras[rn] = chim if chim is not None else Chimera([], [], [], [])
    return chimeras


def merge_scan_products(parts: List[dict], shards=None):
    """Merge per-shard scan products in shard order; decode chimeras.

    Reproduces ``collect_chimeras`` over the unsplit BAM — see
    :func:`merge_scan_parts` / :func:`decode_chimeras`.  ``shards``
    (open BamFiles over the same shard set) enables the rescue pass for
    chimeric reads whose primary record carries no SA tag — the
    single-process paths take the read length from ANY primary of a
    chimeric name (``bamcore.cpp`` parse_sa primary screen;
    ``ops/chimera.py`` all-primaries dict), so the merge must too.
    (The jax.distributed pipeline runs the same three phases with the
    rescue gathered across processes —
    ``parallel.distributed.distributed_reconstruct_graphs``.)
    """
    read_length, sa_buckets, nm_stats = merge_scan_parts(parts)
    if shards is not None:
        missing = [rn for rn in sa_buckets if rn not in read_length]
        read_length.update(_rescue_read_lengths(shards, missing))
    chimeras = decode_chimeras(read_length, sa_buckets)
    return read_length, chimeras, nm_stats


# --------------------------------------------------------------------------
# Shard-set BAM view with deterministic reductions
# --------------------------------------------------------------------------

class MultiShardBam:
    """BamFile-compatible view over an ordered shard set.

    Region reductions are deterministic: coverage/read counts are integer
    sums over shards, name sets are unions, and record-row queries
    concatenate per-shard rows in shard order — since the shards partition
    the coordinate-sorted input contiguously, that equals the unsplit
    file's row order.
    """

    def __init__(self, shard_paths: Sequence[str]):
        self.shards = [BamFile(p) for p in shard_paths]
        self._bases = np.cumsum([0] + [len(s.pos) for s in self.shards])
        self._pos: Optional[np.ndarray] = None
        self._end: Optional[np.ndarray] = None
        self._mapq: Optional[np.ndarray] = None
        self._name_blob: Optional[np.ndarray] = None
        self._name_off: Optional[np.ndarray] = None

    # integer reductions ---------------------------------------------------

    def coverage_sum(self, chrom, start, stop, **kw) -> int:
        return sum(s.coverage_sum(chrom, start, stop, **kw)
                   for s in self.shards)

    def coverage_profile(self, chrom, start, stop, **kw) -> np.ndarray:
        out = None
        for s in self.shards:
            prof = s.coverage_profile(chrom, start, stop, **kw)
            out = prof if out is None else out + prof
        return out

    def read_count(self, chrom, start, stop) -> int:
        return sum(s.read_count(chrom, start, stop) for s in self.shards)

    def names_overlapping(self, chrom, start, stop) -> set:
        out: set = set()
        for s in self.shards:
            out |= s.names_overlapping(chrom, start, stop)
        return out

    # order-preserving concatenations -------------------------------------

    def del_gap_alignments(self, *args, **kw) -> list:
        rows: list = []
        for s in self.shards:
            rows.extend(s.del_gap_alignments(*args, **kw))
        return rows

    def overlap_rows(self, chrom, start, stop):
        for k, s in enumerate(self.shards):
            lo, hi = s.overlap_range(chrom, start, stop)
            base = int(self._bases[k])
            yield from range(base + lo, base + hi)

    def region_records(self, chrom, start, stop):
        # shard order == unsplit row order (contiguous record slices)
        for s in self.shards:
            yield from s.region_records(chrom, start, stop)

    # concatenated flat columns (lazily materialized) ----------------------

    @property
    def pos(self) -> np.ndarray:
        if self._pos is None:
            self._pos = np.concatenate([np.asarray(s.pos) for s in self.shards])
        return self._pos

    @property
    def end(self) -> np.ndarray:
        if self._end is None:
            self._end = np.concatenate([np.asarray(s.end) for s in self.shards])
        return self._end

    @property
    def mapq(self) -> np.ndarray:
        if self._mapq is None:
            self._mapq = np.concatenate(
                [np.asarray(s.mapq) for s in self.shards])
        return self._mapq

    @property
    def name_blob(self) -> np.ndarray:
        if self._name_blob is None:
            self._name_blob = np.concatenate(
                [np.frombuffer(bytes(s.name_blob), np.uint8)
                 for s in self.shards])
        return self._name_blob

    @property
    def name_off(self) -> np.ndarray:
        if self._name_off is None:
            parts = []
            shift = 0
            for k, s in enumerate(self.shards):
                off = np.asarray(s.name_off, np.int64)
                parts.append(off[:-1] + shift if k < len(self.shards) - 1
                             else off + shift)
                shift += int(off[-1])
            self._name_off = np.concatenate(parts)
        return self._name_off

    def close(self) -> None:
        for s in self.shards:
            s.close()


# --------------------------------------------------------------------------
# End-to-end entry point
# --------------------------------------------------------------------------

def multihost_reconstruct_graphs(
    shard_paths: Sequence[str],
    cnv_seed: str,
    cn_seg: str,
    output_prefix: str,
    cfg=None,
    processes: Optional[int] = None,
    *,
    device,
):
    """Graph reconstruction with the whole-BAM scan fanned out over one
    process per shard (the per-host ingest of a multi-host deployment);
    the stages after the merge run in this process, their device engines
    on ``device``.  The workers scan on the host and never touch a card.

    Byte-identical outputs to single-process ``reconstruct_graphs`` on the
    unsplit BAM — see module docstring for the determinism argument.
    """
    import multiprocessing as mp

    from ..config import DEFAULT_CONFIG
    from ..graph.breakpoint_graph import write_graph_file
    from ..reconstruct import Reconstruction

    cfg = cfg or DEFAULT_CONFIG
    ctx = mp.get_context("spawn")
    with ctx.Pool(processes or len(shard_paths)) as pool:
        parts = pool.map(scan_shard, list(shard_paths))
    bam = MultiShardBam(shard_paths)
    read_length, chimeras, nm_stats = merge_scan_products(
        parts, shards=bam.shards)
    rec = Reconstruction(bam, cnv_seed, cfg, device=device)
    rec.read_cns(cn_seg)
    rec.read_length = read_length
    rec.chimeras = chimeras
    rec.nm_stats = nm_stats
    rec.hash_to_segments()
    rec.find_amplicon_intervals()
    rec.find_smalldel_breakpoints()
    rec.find_breakpoints()
    rec.build_graph()
    rec.assign_cov()
    rec.compute_cn()
    for gi, g in enumerate(rec.graphs):
        write_graph_file(g, f"{output_prefix}_amplicon{gi + 1}_graph.txt")
    return rec
