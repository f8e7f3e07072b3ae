"""ctypes bindings for the native BAM core (``bamcore.cpp``).

Exposes ``scan_into(bamfile, path)`` which populates a
``coral_tpu_torch.io.bam.BamFile`` with zero-copy numpy views over the C++
structure-of-arrays record table, plus region-query wrappers used by
``BamFile`` when the native backend is active, and ``counters()``, the
library's process-wide counts of payload bytes inflated and of the records
its region decodes answered from the scan's columns or walked.
"""
from __future__ import annotations

import ctypes as C
import os
import numpy as np

from . import _build
from ..tracing import span

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = C.CDLL(str(_build.build("bamcore")))
    lib.bc_open.restype = C.c_void_p
    lib.bc_open.argtypes = [C.c_char_p, C.c_int]
    lib.bc_open_cached.restype = C.c_void_p
    lib.bc_open_cached.argtypes = [C.c_char_p, C.c_char_p, C.c_int]
    lib.bc_from_cache.restype = C.c_int32
    lib.bc_from_cache.argtypes = [C.c_void_p]
    lib.bc_close.argtypes = [C.c_void_p]
    lib.bc_counters.restype = C.c_int
    lib.bc_counters.argtypes = [C.POINTER(C.c_int64), C.c_int]
    lib.bc_error.restype = C.c_char_p
    lib.bc_error.argtypes = [C.c_void_p]
    lib.bc_nrecords.restype = C.c_int64
    lib.bc_nrecords.argtypes = [C.c_void_p]
    lib.bc_nrefs.restype = C.c_int32
    lib.bc_nrefs.argtypes = [C.c_void_p]
    lib.bc_ref_name.restype = C.c_char_p
    lib.bc_ref_name.argtypes = [C.c_void_p, C.c_int32]
    lib.bc_ref_len.restype = C.c_int64
    lib.bc_ref_len.argtypes = [C.c_void_p, C.c_int32]
    for fn, ty in [
        ("bc_col_flag", C.c_uint16), ("bc_col_ref", C.c_int32),
        ("bc_col_pos", C.c_int64), ("bc_col_end", C.c_int64),
        ("bc_col_mapq", C.c_uint8), ("bc_col_qlen", C.c_int32),
        ("bc_col_nm", C.c_int64), ("bc_name_off", C.c_int64),
        ("bc_col_aligned", C.c_int64), ("bc_col_max_gap", C.c_int64),
        ("bc_sa_off", C.c_int64), ("bc_sa_len", C.c_int64),
        ("bc_name_blob", C.c_uint8), ("bc_sa_blob", C.c_uint8),
    ]:
        getattr(lib, fn).restype = C.POINTER(ty)
        getattr(lib, fn).argtypes = [C.c_void_p]
    lib.bc_name_blob_len.restype = C.c_int64
    lib.bc_name_blob_len.argtypes = [C.c_void_p]
    lib.bc_sa_blob_len.restype = C.c_int64
    lib.bc_sa_blob_len.argtypes = [C.c_void_p]
    lib.bc_coverage_sum.restype = C.c_int64
    lib.bc_coverage_sum.argtypes = [C.c_void_p] + [C.c_int64] * 4 + [C.c_int] * 3
    lib.bc_coverage_profile.restype = C.c_int
    lib.bc_coverage_profile.argtypes = (
        [C.c_void_p] + [C.c_int64] * 4 + [C.c_int] * 3 + [C.POINTER(C.c_int64)]
    )
    lib.bc_del_gaps.restype = C.c_int64
    lib.bc_del_gaps.argtypes = [C.c_void_p] + [C.c_int64] * 4 + [C.c_int]
    lib.bc_del_gaps_fetch.argtypes = [C.c_void_p] + [C.POINTER(C.c_int64)] * 5
    lib.bc_parse_sa.restype = C.c_int64
    lib.bc_parse_sa.argtypes = [C.c_void_p]
    lib.bc_cluster_firstfit.restype = C.c_int64
    lib.bc_cluster_firstfit.argtypes = (
        C.c_int64, C.POINTER(C.c_int64), C.POINTER(C.c_int64),
        C.c_int64, C.POINTER(C.c_int32))
    lib.bc_pack_pairs.restype = None
    lib.bc_pack_pairs.argtypes = (
        [C.c_int64] + [C.POINTER(C.c_int64)] * 5
        + [C.POINTER(C.c_int32), C.POINTER(C.c_int8), C.POINTER(C.c_int32)]
        + [C.c_int64, C.c_int] + [C.POINTER(C.c_int32)] * 6
    )
    lib.bc_pack_pairs2.restype = None
    lib.bc_pack_pairs2.argtypes = (
        [C.c_int64] + [C.POINTER(C.c_int64)] * 5
        + [C.POINTER(C.c_int32), C.POINTER(C.c_int8), C.POINTER(C.c_int32)]
        + [C.c_int64, C.c_int32, C.POINTER(C.c_int32)]
        + [C.POINTER(C.c_int64)] * 2
        + [C.c_int64, C.c_int] + [C.POINTER(C.c_int32)] * 4
    )
    lib.bc_pack_pairs3.restype = None
    lib.bc_pack_pairs3.argtypes = (
        [C.c_int64] + [C.POINTER(C.c_int64)] * 5
        + [C.POINTER(C.c_int32), C.POINTER(C.c_int8), C.POINTER(C.c_int32)]
        + [C.c_int64, C.c_int32, C.POINTER(C.c_int32)]
        + [C.POINTER(C.c_int64)] * 2
        + [C.c_int32, C.c_int64, C.c_int] + [C.POINTER(C.c_int32)] * 3
    )
    for fn, ty in [
        ("bc_chim_rec", C.c_int64), ("bc_chim_off", C.c_int64),
        ("bc_chim_rl", C.c_int32),
        ("bc_aln_qs", C.c_int64), ("bc_aln_qe", C.c_int64),
        ("bc_aln_r1", C.c_int64), ("bc_aln_r2", C.c_int64),
        ("bc_aln_ref", C.c_int32), ("bc_aln_mapq", C.c_int32),
        ("bc_aln_strand", C.c_int8), ("bc_aln_nm", C.c_double),
    ]:
        getattr(lib, fn).restype = C.POINTER(ty)
        getattr(lib, fn).argtypes = [C.c_void_p]
    _lib = lib
    return lib


def _as_np(ptr, dtype, n):
    if n == 0:
        return np.zeros(0, dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).view(dtype)


class NativeBam:
    """Owns the C++ handle; arrays are views into C++ memory."""

    def __init__(self, path: str, nthreads: int = 0,
                 cache_path: str | None = None):
        lib = _load()
        if nthreads <= 0:
            nthreads = min(os.cpu_count() or 1, 8)
        self._lib = lib
        if cache_path:
            self._h = lib.bc_open_cached(
                path.encode(), cache_path.encode(), nthreads)
        else:
            self._h = lib.bc_open(path.encode(), nthreads)
        err = lib.bc_error(self._h)
        if err:
            msg = err.decode()
            lib.bc_close(self._h)
            self._h = None
            raise ValueError(f"{path}: {msg}")
        self.from_cache = bool(cache_path and lib.bc_from_cache(self._h))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.bc_close(self._h)
            self._h = None


def scan_into(bam, path: str, cache_path: str | None = None) -> None:
    """Populate a BamFile's table from the native scanner (or its scan
    cache — see ``bc_open_cached``: the cache loads when it matches the
    BAM's (size, mtime) and is written after a fresh scan otherwise)."""
    with span("bam.scan"):
        nb = NativeBam(path, cache_path=cache_path)
    bam.scan_from_cache = nb.from_cache
    lib, h = nb._lib, nb._h
    n = lib.bc_nrecords(h)
    bam._native = nb  # keep C++ memory alive
    bam.n_records = int(n)
    bam.references = [
        (lib.bc_ref_name(h, i).decode(), int(lib.bc_ref_len(h, i)))
        for i in range(lib.bc_nrefs(h))
    ]
    bam.flag = _as_np(lib.bc_col_flag(h), np.uint16, n)
    bam.ref_id = _as_np(lib.bc_col_ref(h), np.int32, n)
    bam.pos = _as_np(lib.bc_col_pos(h), np.int64, n)
    bam.end = _as_np(lib.bc_col_end(h), np.int64, n)
    bam.mapq = _as_np(lib.bc_col_mapq(h), np.uint8, n)
    bam.qlen = _as_np(lib.bc_col_qlen(h), np.int32, n)
    bam.nm = _as_np(lib.bc_col_nm(h), np.int64, n)
    # each record's aligned bases and largest gap between aligned ops,
    # which answer most of a region decode without inflating it
    bam.aligned = _as_np(lib.bc_col_aligned(h), np.int64, n)
    bam.max_gap = _as_np(lib.bc_col_max_gap(h), np.int64, n)
    bam.name_off = _as_np(lib.bc_name_off(h), np.int64, n + 1)
    nb_len = lib.bc_name_blob_len(h)
    bam.name_blob = bytes(_as_np(lib.bc_name_blob(h), np.uint8, nb_len)) if nb_len else b""
    bam.sa_off = _as_np(lib.bc_sa_off(h), np.int64, n)
    bam.sa_len = _as_np(lib.bc_sa_len(h), np.int64, n)
    sb_len = lib.bc_sa_blob_len(h)
    bam.sa_blob = bytes(_as_np(lib.bc_sa_blob(h), np.uint8, sb_len)) if sb_len else b""


COUNTERS = ("scan_inflated_bytes", "decode_inflated_bytes",
            "decode_pooled_bytes", "decode_column_records",
            "decode_walked_records")


def counters() -> dict:
    """The library's counters in this process: BGZF payload bytes inflated
    by the scan, by region decodes, and by region decodes on more than one
    thread; records of region decodes answered from the scan's columns and
    records walked from inflated bytes.  They survive ``bc_close``.
    Raises OSError when the library cannot be built."""
    lib = _load()
    out = (C.c_int64 * len(COUNTERS))()
    lib.bc_counters(out, len(COUNTERS))
    return dict(zip(COUNTERS, map(int, out)))


def parse_sa(bam):
    """Native chimera assembly.  Returns (chim_rec, chim_off, columns)
    where columns = (qs, qe, ref_id, r1, r2, strand, mapq, nm)."""
    nb = bam._native
    lib, h = nb._lib, nb._h
    n_chim = lib.bc_parse_sa(h)
    n_aln = int(_as_np(lib.bc_chim_off(h), np.int64, n_chim + 1)[-1]) \
        if n_chim else 0
    chim_rec = _as_np(lib.bc_chim_rec(h), np.int64, n_chim)
    chim_rl = _as_np(lib.bc_chim_rl(h), np.int32, n_chim)
    chim_off = _as_np(lib.bc_chim_off(h), np.int64, n_chim + 1)
    cols = (
        _as_np(lib.bc_aln_qs(h), np.int64, n_aln),
        _as_np(lib.bc_aln_qe(h), np.int64, n_aln),
        _as_np(lib.bc_aln_ref(h), np.int32, n_aln),
        _as_np(lib.bc_aln_r1(h), np.int64, n_aln),
        _as_np(lib.bc_aln_r2(h), np.int64, n_aln),
        _as_np(lib.bc_aln_strand(h), np.int8, n_aln),
        _as_np(lib.bc_aln_mapq(h), np.int32, n_aln),
        _as_np(lib.bc_aln_nm(h), np.float64, n_aln),
    )
    return chim_rec, chim_rl, chim_off, cols


def pack_pairs(pi, qs, qe, r1, r2, chrom, strand, mapq,
               n_out: int | None = None, nthreads: int = 0):
    """Native adjacent-pair packing: gathers pair (pi[p], pi[p]+1) from
    the flat alignment columns and emits the 6-column device layout
    (``ops.scoring.PACKED_COL_ORDER``) in one threaded pass —
    bit-identical to ``pack_pair_cols(np, ...)`` over the gathered
    columns, with rows [n_pairs, n_out) zero-padded (inert: meta 0
    decodes to chrom -1, matching no interval).

    Returns a list of 6 int32 arrays of length ``n_out``
    (default: n_pairs).  Raises OSError when the native library is
    unavailable (callers fall back to the numpy path)."""
    lib = _load()
    pi = np.ascontiguousarray(pi, np.int64)
    qs = np.ascontiguousarray(qs, np.int64)
    qe = np.ascontiguousarray(qe, np.int64)
    r1 = np.ascontiguousarray(r1, np.int64)
    r2 = np.ascontiguousarray(r2, np.int64)
    chrom = np.ascontiguousarray(chrom, np.int32)
    strand = np.ascontiguousarray(strand, np.int8)
    mapq = np.ascontiguousarray(mapq, np.int32)
    n_pairs = len(pi)
    if n_out is None:
        n_out = n_pairs
    if nthreads <= 0:
        nthreads = min(os.cpu_count() or 1, 8)
    # np.empty, not zeros: the native pass writes every byte exactly once
    # (this microVM pays ~38s/GB on first touch; see CLAUDE.md)
    outs = [np.empty(n_out, np.int32) for _ in range(6)]
    i64p = C.POINTER(C.c_int64)
    i32p = C.POINTER(C.c_int32)
    lib.bc_pack_pairs(
        n_pairs, pi.ctypes.data_as(i64p),
        qs.ctypes.data_as(i64p), qe.ctypes.data_as(i64p),
        r1.ctypes.data_as(i64p), r2.ctypes.data_as(i64p),
        chrom.ctypes.data_as(i32p),
        strand.ctypes.data_as(C.POINTER(C.c_int8)),
        mapq.ctypes.data_as(i32p),
        n_out, nthreads,
        *[o.ctypes.data_as(i32p) for o in outs])
    return outs


def pack_pairs2(pi, qs, qe, r1, r2, chrom, strand, mapq,
                int_chrom, int_start, int_end,
                n_out: int | None = None, nthreads: int = 0):
    """Native interval-RESOLVED pair packing: the per-alignment
    first_overlap search plus the pair gather+pack, one threaded pass
    each, emitting the 4-column v2 device layout
    (``ops.scoring.PACKED2_COL_ORDER``) — bit-identical to
    ``ops.scoring.pack_pairs2_host`` by test, rows [n_pairs, n_out)
    zero-padded (inert: meta 0 decodes to iog -1).

    Returns a list of 4 int32 arrays of length ``n_out`` (default:
    n_pairs).  Raises OSError when the native library is unavailable
    (callers fall back to the host path)."""
    lib = _load()
    pi = np.ascontiguousarray(pi, np.int64)
    qs = np.ascontiguousarray(qs, np.int64)
    qe = np.ascontiguousarray(qe, np.int64)
    r1 = np.ascontiguousarray(r1, np.int64)
    r2 = np.ascontiguousarray(r2, np.int64)
    chrom = np.ascontiguousarray(chrom, np.int32)
    strand = np.ascontiguousarray(strand, np.int8)
    mapq = np.ascontiguousarray(mapq, np.int32)
    ic = np.ascontiguousarray(int_chrom, np.int32)
    is_ = np.ascontiguousarray(int_start, np.int64)
    ie = np.ascontiguousarray(int_end, np.int64)
    n_pairs = len(pi)
    n_aln = len(r1)
    if n_out is None:
        n_out = n_pairs
    if nthreads <= 0:
        nthreads = min(os.cpu_count() or 1, 8)
    # np.empty, not zeros: the native pass writes every byte exactly once
    outs = [np.empty(n_out, np.int32) for _ in range(4)]
    i64p = C.POINTER(C.c_int64)
    i32p = C.POINTER(C.c_int32)
    lib.bc_pack_pairs2(
        n_pairs, pi.ctypes.data_as(i64p),
        qs.ctypes.data_as(i64p), qe.ctypes.data_as(i64p),
        r1.ctypes.data_as(i64p), r2.ctypes.data_as(i64p),
        chrom.ctypes.data_as(i32p),
        strand.ctypes.data_as(C.POINTER(C.c_int8)),
        mapq.ctypes.data_as(i32p),
        n_aln, len(ic), ic.ctypes.data_as(i32p),
        is_.ctypes.data_as(i64p), ie.ctypes.data_as(i64p),
        n_out, nthreads,
        *[o.ctypes.data_as(i32p) for o in outs])
    return outs


def pack_pairs3(pi, qs, qe, r1, r2, chrom, strand, mapq,
                int_chrom, int_start, int_end, min_mapq: int = 20,
                n_out: int | None = None, nthreads: int = 0):
    """Native fully-RESOLVED pair packing (v3): per-alignment
    first_overlap search, the per-side MAPQ gate folded into the
    combined gate, and the same-strand reference jump pre-derived —
    emitting the 3-column v3 device layout
    (``ops.scoring.PACKED3_COL_ORDER``), bit-identical to
    ``ops.scoring.pack_pairs3_host`` by test, rows [n_pairs, n_out)
    zero-padded (inert: meta 0 decodes to iogm -1).

    Returns a list of 3 int32 arrays of length ``n_out`` (default:
    n_pairs).  Raises OSError when the native library is unavailable
    (callers fall back to the host path)."""
    lib = _load()
    pi = np.ascontiguousarray(pi, np.int64)
    qs = np.ascontiguousarray(qs, np.int64)
    qe = np.ascontiguousarray(qe, np.int64)
    r1 = np.ascontiguousarray(r1, np.int64)
    r2 = np.ascontiguousarray(r2, np.int64)
    chrom = np.ascontiguousarray(chrom, np.int32)
    strand = np.ascontiguousarray(strand, np.int8)
    mapq = np.ascontiguousarray(mapq, np.int32)
    ic = np.ascontiguousarray(int_chrom, np.int32)
    is_ = np.ascontiguousarray(int_start, np.int64)
    ie = np.ascontiguousarray(int_end, np.int64)
    n_pairs = len(pi)
    n_aln = len(r1)
    if n_out is None:
        n_out = n_pairs
    if nthreads <= 0:
        nthreads = min(os.cpu_count() or 1, 8)
    # np.empty, not zeros: the native pass writes every byte exactly once
    outs = [np.empty(n_out, np.int32) for _ in range(3)]
    i64p = C.POINTER(C.c_int64)
    i32p = C.POINTER(C.c_int32)
    lib.bc_pack_pairs3(
        n_pairs, pi.ctypes.data_as(i64p),
        qs.ctypes.data_as(i64p), qe.ctypes.data_as(i64p),
        r1.ctypes.data_as(i64p), r2.ctypes.data_as(i64p),
        chrom.ctypes.data_as(i32p),
        strand.ctypes.data_as(C.POINTER(C.c_int8)),
        mapq.ctypes.data_as(i32p),
        n_aln, len(ic), ic.ctypes.data_as(i32p),
        is_.ctypes.data_as(i64p), ie.ctypes.data_as(i64p),
        int(min_mapq), n_out, nthreads,
        *[o.ctypes.data_as(i32p) for o in outs])
    return outs


def _native_error(nb) -> str:
    """bc_error returns NULL (ctypes None) when no message was recorded
    (e.g. a clean-EOF failure inside decode_range); never AttributeError
    on the error path."""
    msg = nb._lib.bc_error(nb._h)
    return msg.decode() if msg else "native bamcore error (no message)"


def coverage_sum(bam, lo, hi, start, stop, quality_threshold, flag_exclude, min_mapq):
    nb = bam._native
    r = nb._lib.bc_coverage_sum(nb._h, lo, hi, start, stop,
                                quality_threshold, flag_exclude, min_mapq)
    if r < 0:
        raise RuntimeError(_native_error(nb))
    return int(r)


def coverage_profile(bam, lo, hi, start, stop, quality_threshold, flag_exclude, min_mapq):
    nb = bam._native
    out = np.zeros(stop - start, np.int64)
    rc = nb._lib.bc_coverage_profile(
        nb._h, lo, hi, start, stop, quality_threshold, flag_exclude, min_mapq,
        out.ctypes.data_as(C.POINTER(C.c_int64)),
    )
    if rc != 0:
        raise RuntimeError(_native_error(nb))
    return out


def del_gaps(bam, lo, hi, start, min_del_len, min_mapq):
    """Returns (rec_idx, next_start, prev_end, blk_first, blk_last) arrays."""
    nb = bam._native
    cnt = nb._lib.bc_del_gaps(nb._h, lo, hi, start, min_del_len, min_mapq)
    if cnt < 0:
        raise RuntimeError(_native_error(nb))
    arrs = [np.zeros(cnt, np.int64) for _ in range(5)]
    nb._lib.bc_del_gaps_fetch(
        nb._h, *[a.ctypes.data_as(C.POINTER(C.c_int64)) for a in arrs]
    )
    return tuple(arrs)


def cluster_firstfit(p1, p2, cutoff: int) -> np.ndarray:
    """Native greedy first-fit clustering of one breakpoint group:
    cluster id per member (creation order), bit-identical to the Python
    _PosBuffer scan (``ops/breakpoints._cluster_group_host``).  Raises
    OSError when the native library is unavailable."""
    lib = _load()
    p1 = np.ascontiguousarray(p1, np.int64)
    p2 = np.ascontiguousarray(p2, np.int64)
    out = np.empty(len(p1), np.int32)
    lib.bc_cluster_firstfit(
        len(p1), p1.ctypes.data_as(C.POINTER(C.c_int64)),
        p2.ctypes.data_as(C.POINTER(C.c_int64)), int(cutoff),
        out.ctypes.data_as(C.POINTER(C.c_int32)))
    return out
