"""The hand-written CUDA kernels of the port, each beside its plain
PyTorch version (the counterpart of ``coral_tpu/ops/pallas_kernels.py``,
all nine of its kernels, K1 to K9).

A wrapper takes the plain version only for tensors on the CPU.  For a
CUDA tensor it launches its kernel (``csrc/*.cu``, built on first use by
:mod:`._build`) or raises; it never falls back.  :data:`LAUNCHES` counts
kernel launches, so a run can show that it went through them.

K1, K2 and K7 stream 12 B per pair of the packed v3 layout
(:data:`.scoring.PACKED3_COL_ORDER`), K5 and K6 16 B per pair of the v2
layout (:data:`.scoring.PACKED2_COL_ORDER`); all five are bound by device
memory bandwidth.  K2 and K6 share one body (``csrc/pair_common.cuh``):
one shared-memory atomic per hit, a block's counts added into the output
at its end, the output zeroed by a memset on the same stream.  K3 and K4
stream 24 B per pair of the 6-column layout
(:data:`.scoring.PACKED_COL_ORDER`) and find each side's first interval
by a scan of the table up to :data:`PAIR6_SCAN_MAX_INTERVALS` (bound by
bandwidth at a handful of intervals) and by lookups in the table's
:class:`.interval_index.IntervalIndex` above (bound by the lookups'
dependent loads); K4 counts its hits on the SM at any number of intervals
(every bin in shared memory up to 8190, a cache of 2048 bins above) into
an output zeroed by a memset.  K8
(aligned bases per genome bin) streams 8 B per read and makes at most four
updates a read, merged per lane and per warp, in shared-memory tiles of
the bins (:func:`bin_overlap_plan`); K9 (the match matrix of a
clustering group) writes one byte per cell for about nine integer
operations.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..device import resolve_device
from .interval_index import IntervalIndex, build_interval_index
from .scoring import MAX_PACKED2_INTERVALS, as_tensor, \
    pair_predicate_packed, pair_predicate_packed2, pair_predicate_packed3

LAUNCHES = {"pair3": 0, "pair3_support": 0, "pair6": 0, "pair6_support": 0,
            "stream_control": 0, "pair2": 0, "pair2_support": 0,
            "bin_overlap": 0, "match_matrix": 0, "interval_index": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_cols(what: str, *cols) -> int:
    """Each of ``cols`` a contiguous 1-D int32 tensor, all of one length
    and on one CPU or CUDA device; returns the length."""
    first = cols[0]
    n = first.shape[0] if first.dim() == 1 else -1
    for t in cols:
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{what} must be 1-D int32 tensors of one "
                             "length")
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
        if t.device != first.device:
            raise ValueError(f"{what} must be on one device")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {first.device}")
    return n


def _launch(name: str, entry: str, on: torch.Tensor, *args) -> None:
    """Call the C entry ``entry`` (building the library on first use) with
    ``args`` and the device and current stream of ``on``; raise if the
    launch was refused, else count it under ``name``."""
    from . import _build

    lib = _build.load()
    rc = getattr(lib, entry)(
        *args, on.device.index or 0,
        torch.cuda.current_stream(on.device).cuda_stream)
    _build.check(lib, rc, f"{name} launch")
    LAUNCHES[name] += 1


def pair3_hitmask_torch(qgap, grr, meta, cutoff: int, gap_: float):
    """Plain version of K1: the v3 hit mask, bool (n,)."""
    return pair_predicate_packed3(qgap, grr, meta, cutoff, gap_)[0]


def pair3_support_torch(qgap, grr, meta, n_int: int, cutoff: int,
                        gap_: float):
    """Plain version of K2: per-interval support counts, int32 (n_int,).
    Gate indices past ``n_int`` are dropped, as the TPU kernel drops them."""
    hit, iogm = pair_predicate_packed3(qgap, grr, meta, cutoff, gap_)
    counts = torch.bincount(iogm[hit], minlength=n_int)[:n_int]
    return counts.to(torch.int32)


def pair3_hitmask(qgap, grr, meta, cutoff: int, gap_: float):
    """K1 (replaces ``_pair3_kernel``, ``coral_tpu/ops/pallas_kernels.py``):
    the hit mask of each packed v3 pair, bool (n,)."""
    n = _check_cols("qgap, grr, meta", qgap, grr, meta)
    if qgap.device.type == "cpu":
        return pair3_hitmask_torch(qgap, grr, meta, cutoff, gap_)
    out = torch.empty(n, dtype=torch.bool, device=qgap.device)
    if n == 0:
        return out
    _launch("pair3", "coral_pair3_hitmask", qgap,
            qgap.data_ptr(), grr.data_ptr(), meta.data_ptr(), out.data_ptr(),
            n, int(cutoff), float(gap_))
    return out


def pair3_support(qgap, grr, meta, n_int: int, cutoff: int, gap_: float):
    """K2 (replaces ``_pair_hist3_kernel``): the v3 predicate fused with
    the per-interval support histogram, int32 (n_int,).  One call is a
    memset of the output and one launch, at any ``n`` (0 included)."""
    n = _check_cols("qgap, grr, meta", qgap, grr, meta)
    if not 1 <= n_int <= MAX_PACKED2_INTERVALS:
        raise ValueError(f"n_int={n_int} outside 1..{MAX_PACKED2_INTERVALS}")
    if qgap.device.type == "cpu":
        return pair3_support_torch(qgap, grr, meta, n_int, cutoff, gap_)
    out = torch.empty(n_int, dtype=torch.int32, device=qgap.device)
    _launch("pair3_support", "coral_pair3_support", qgap,
            qgap.data_ptr(), grr.data_ptr(), meta.data_ptr(), out.data_ptr(),
            n, int(n_int), int(cutoff), float(gap_))
    return out


def stream_control_torch(qgap, grr, meta):
    """Plain version of K7: ``qgap + grr + meta``, int32 (wraps)."""
    return qgap + grr + meta


def stream_control(qgap, grr, meta):
    """K7 (replaces ``_stream_control_kernel``): the zero-compute copy
    control on K1's grid, reading K1's three columns and writing one int32
    per pair.  A measuring stick for K1 and K2; nothing on the main path
    needs its values."""
    n = _check_cols("qgap, grr, meta", qgap, grr, meta)
    if qgap.device.type == "cpu":
        return stream_control_torch(qgap, grr, meta)
    out = torch.empty(n, dtype=torch.int32, device=qgap.device)
    if n == 0:
        return out
    _launch("stream_control", "coral_stream_control", qgap,
            qgap.data_ptr(), grr.data_ptr(), meta.data_ptr(), out.data_ptr(),
            n)
    return out


def _check_pair6(int_chrom, int_start, int_end, packed6):
    """-> (n_int, n) of an int32 interval table and six packed columns."""
    n_int = _check_cols("int_chrom, int_start, int_end", int_chrom,
                        int_start, int_end)
    n = _check_cols("the packed columns", *packed6)
    if int_chrom.device != packed6[0].device:
        raise ValueError("interval table and packed columns must be on one "
                         "device")
    return n_int, n


def pair6_hitmask_torch(int_chrom, int_start, int_end, *packed6, cutoff: int,
                        min_mapq: int, gap_: float):
    """Plain version of K3: (hit bool (n,), io_i int32 (n,))."""
    hit, io = pair_predicate_packed(*packed6, int_chrom, int_start, int_end,
                                    cutoff, min_mapq, gap_)
    return hit, io.to(torch.int32)


def pair6_support_torch(int_chrom, int_start, int_end, *packed6, cutoff: int,
                        min_mapq: int, gap_: float):
    """Plain version of K4: per-interval support counts, int32 (n_int,)."""
    n_int = int_chrom.shape[0]
    hit, io = pair_predicate_packed(*packed6, int_chrom, int_start, int_end,
                                    cutoff, min_mapq, gap_)
    return torch.bincount(io[hit], minlength=n_int)[:n_int].to(torch.int32)


# K3 and K4 scan the interval table up to this many intervals and look
# each side up in the interval index above: on the card the two tie at
# 64 intervals and the index is 1.6x faster at 128 (csrc/pair6.cu)
PAIR6_SCAN_MAX_INTERVALS = 64


def _pair6_index(int_chrom, int_start, int_end, index):
    """The index arguments of K3's and K4's C entries: those of ``index``
    (built here when None) above :data:`PAIR6_SCAN_MAX_INTERVALS`
    intervals, nulls (the scan) up to it."""
    n_int = int_chrom.shape[0]
    if n_int <= PAIR6_SCAN_MAX_INTERVALS:
        return None, None, None, 0
    if index is None:
        index = build_interval_index(int_chrom, int_start, int_end,
                                     int_chrom.device)
    elif not isinstance(index, IntervalIndex) or index.n != n_int \
            or index.device != int_chrom.device:
        raise ValueError("index must be build_interval_index of this table, "
                         "on its device")
    return (index.skey.data_ptr(), index.ekey.data_ptr(),
            index.lev.data_ptr(), index.top)


def pair6_hitmask(int_chrom, int_start, int_end, qgap, r1_i, r2_i, r1_j,
                  r2_j, meta, cutoff: int, min_mapq: int, gap_: float,
                  index: IntervalIndex | None = None):
    """K3 (replaces ``_pair_kernel`` with ``_first_overlap_scan``): the
    6-column predicate over an int32 interval table of any length, the
    first overlaps found by a scan of the table in the kernel up to
    :data:`PAIR6_SCAN_MAX_INTERVALS` intervals and by lookups in the
    table's :class:`.interval_index.IntervalIndex` above (``index``, or
    built in the call).  Returns (hit bool (n,), io_i int32 (n,)):
    ``io_i`` is the first interval overlapping side i, -1 if none,
    whatever side j does."""
    packed6 = (qgap, r1_i, r2_i, r1_j, r2_j, meta)
    n_int, n = _check_pair6(int_chrom, int_start, int_end, packed6)
    if qgap.device.type == "cpu":
        return pair6_hitmask_torch(int_chrom, int_start, int_end, *packed6,
                                   cutoff=cutoff, min_mapq=min_mapq,
                                   gap_=gap_)
    hit = torch.empty(n, dtype=torch.bool, device=qgap.device)
    io = torch.empty(n, dtype=torch.int32, device=qgap.device)
    if n == 0:
        return hit, io
    ix = _pair6_index(int_chrom, int_start, int_end, index)
    _launch("pair6", "coral_pair6_hitmask", qgap,
            int_chrom.data_ptr(), int_start.data_ptr(), int_end.data_ptr(),
            *(c.data_ptr() for c in packed6), hit.data_ptr(), io.data_ptr(), n,
            n_int, int(cutoff), int(min_mapq), float(gap_), *ix)
    return hit, io


def pair6_support(int_chrom, int_start, int_end, qgap, r1_i, r2_i, r1_j,
                  r2_j, meta, cutoff: int, min_mapq: int, gap_: float,
                  index: IntervalIndex | None = None):
    """K4 (replaces ``_pair_hist_kernel``): K3 fused with the per-interval
    support histogram of ``hit & (io_i == k)``, int32 (n_int,), on K3's
    two routes (``index`` as there).  A block counts on the SM: every
    interval's bin in shared memory up to 8190 intervals, above that a
    direct-mapped cache of 2048 bins (slot ``k % 2048``, kept by the first
    interval that reaches it; the others of that slot go to device
    memory).  The counts are exact either way.  One call is a memset of
    the output and one launch, at any ``n`` (0 included), besides the
    index's build."""
    packed6 = (qgap, r1_i, r2_i, r1_j, r2_j, meta)
    n_int, n = _check_pair6(int_chrom, int_start, int_end, packed6)
    if qgap.device.type == "cpu":
        return pair6_support_torch(int_chrom, int_start, int_end, *packed6,
                                   cutoff=cutoff, min_mapq=min_mapq,
                                   gap_=gap_)
    out = torch.empty(n_int, dtype=torch.int32, device=qgap.device)
    if n_int == 0:
        return out
    ix = _pair6_index(int_chrom, int_start, int_end, index)
    _launch("pair6_support", "coral_pair6_support", qgap,
            int_chrom.data_ptr(), int_start.data_ptr(), int_end.data_ptr(),
            *(c.data_ptr() for c in packed6), out.data_ptr(), n, n_int,
            int(cutoff), int(min_mapq), float(gap_), *ix)
    return out


def pair2_hitmask_torch(qgap, r2_i, r1_j, meta, cutoff: int, min_mapq,
                        gap_: float):
    """Plain version of K5: (hit bool (n,), iog int32 (n,))."""
    hit, iog = pair_predicate_packed2(qgap, r2_i, r1_j, meta, cutoff,
                                      min_mapq, gap_)
    return hit, iog.to(torch.int32)


def pair2_support_torch(qgap, r2_i, r1_j, meta, n_int: int, cutoff: int,
                        min_mapq, gap_: float):
    """Plain version of K6: per-interval support counts, int32 (n_int,).
    Gate indices past ``n_int`` are dropped, as the TPU kernel drops them."""
    hit, iog = pair_predicate_packed2(qgap, r2_i, r1_j, meta, cutoff,
                                      min_mapq, gap_)
    return torch.bincount(iog[hit], minlength=n_int)[:n_int].to(torch.int32)


def pair2_hitmask(qgap, r2_i, r1_j, meta, cutoff: int, min_mapq,
                  gap_: float):
    """K5 (replaces ``_pair2_kernel``): the predicate over the packed v2
    layout, with the MAPQ gate and the reference jump taken in the kernel.
    Returns (hit bool (n,), iog int32 (n,)): ``iog`` is the interval gate
    as packed, -1 if none, whatever the MAPQs are."""
    n = _check_cols("qgap, r2_i, r1_j, meta", qgap, r2_i, r1_j, meta)
    if qgap.device.type == "cpu":
        return pair2_hitmask_torch(qgap, r2_i, r1_j, meta, cutoff, min_mapq,
                                   gap_)
    hit = torch.empty(n, dtype=torch.bool, device=qgap.device)
    iog = torch.empty(n, dtype=torch.int32, device=qgap.device)
    if n == 0:
        return hit, iog
    _launch("pair2", "coral_pair2_hitmask", qgap,
            qgap.data_ptr(), r2_i.data_ptr(), r1_j.data_ptr(),
            meta.data_ptr(), hit.data_ptr(), iog.data_ptr(), n, int(cutoff),
            int(math.ceil(min_mapq)), float(gap_))
    return hit, iog


def pair2_support(qgap, r2_i, r1_j, meta, n_int: int, cutoff: int, min_mapq,
                  gap_: float):
    """K6 (replaces ``_pair_hist2_kernel``): K5 fused with the
    per-interval support histogram of ``hit & (iog == k)``, int32
    (n_int,).  One call is a memset of the output and one launch, as for
    :func:`pair3_support`."""
    n = _check_cols("qgap, r2_i, r1_j, meta", qgap, r2_i, r1_j, meta)
    if not 1 <= n_int <= MAX_PACKED2_INTERVALS:
        raise ValueError(f"n_int={n_int} outside 1..{MAX_PACKED2_INTERVALS}")
    if qgap.device.type == "cpu":
        return pair2_support_torch(qgap, r2_i, r1_j, meta, n_int, cutoff,
                                   min_mapq, gap_)
    out = torch.empty(n_int, dtype=torch.int32, device=qgap.device)
    _launch("pair2_support", "coral_pair2_support", qgap,
            qgap.data_ptr(), r2_i.data_ptr(), r1_j.data_ptr(),
            meta.data_ptr(), out.data_ptr(), n, int(n_int), int(cutoff),
            int(math.ceil(min_mapq)), float(gap_))
    return out


def pair_predicates_packed2(packed, n: int, min_bp_match_cutoff: int = 100,
                            min_mapq: int = 20, gap_: float = 100.0, *,
                            device):
    """K5 over numpy columns of the v2 layout, as ``bamcore.pack_pairs2``
    or ``scoring.pack_pairs2_host`` emit them, zero-padded or not (the
    counterpart of ``pair_predicates_pallas_packed2``).  Returns numpy
    (hit, iog) trimmed to the first ``n`` pairs."""
    dev = resolve_device(device)
    hit, iog = pair2_hitmask(
        *(as_tensor(c, dev, torch.int32) for c in packed),
        min_bp_match_cutoff, min_mapq, gap_)
    return hit[:n].cpu().numpy(), iog[:n].cpu().numpy()


_I62 = 1 << 62


def _check_bins(origin: int, bin_size: int, n_bins: int) -> None:
    if bin_size < 1 or not 1 <= n_bins < 1 << 31:
        raise ValueError(f"bin_size={bin_size}, n_bins={n_bins}: both must "
                         "be positive")
    if abs(origin) >= _I62 or bin_size * n_bins >= _I62:
        raise ValueError("bin edges exceed int64")


def bin_overlap_torch(starts, ends, origin: int, bin_size: int, n_bins: int):
    """Plain version of K8: int64 (n_bins,).  The kernel's decomposition in
    tensor ops: a read clipped to ``[lo, hi)`` adds its overlaps with its
    first and last bin (``index_add_``), and the whole bins between them
    enter a difference array of counts whose ``cumsum`` times ``bin_size``
    is added at the end."""
    _check_bins(origin, bin_size, n_bins)
    last_edge = origin + bin_size * n_bins
    lo = starts.to(torch.int64).clamp(min=origin)
    hi = ends.to(torch.int64).clamp(max=last_edge)
    live = hi > lo
    lo, hi = lo[live], hi[live]
    b0 = torch.div(lo - origin, bin_size, rounding_mode="floor")
    b1 = torch.div(hi - 1 - origin, bin_size, rounding_mode="floor")
    one = b0 == b1
    out = torch.zeros(n_bins, dtype=torch.int64, device=starts.device)
    out.index_add_(0, b0, torch.where(one, hi, origin + (b0 + 1) * bin_size)
                   - lo)
    two = ~one
    out.index_add_(0, b1[two], hi[two] - (origin + b1[two] * bin_size))
    whole = b1 > b0 + 1
    counts = torch.zeros(n_bins, dtype=torch.int64, device=starts.device)
    ones = torch.ones(int(whole.sum()), dtype=torch.int64,
                      device=starts.device)
    counts.index_add_(0, b0[whole] + 1, ones)
    counts.index_add_(0, b1[whole], -ones)
    return out + bin_size * counts.cumsum(0)


@functools.lru_cache(maxsize=256)
def _bin_plan(device: int, n: int, n_bins: int):
    from . import _build

    lib = _build.load()
    plan = (ctypes.c_int * 3)()
    rc = lib.coral_bin_overlap_plan(n, n_bins, device, plan)
    _build.check(lib, rc, "bin_overlap plan")
    return tuple(plan)


def bin_overlap_plan(n: int, n_bins: int, device):
    """How K8 runs ``n`` reads over ``n_bins`` bins on the CUDA ``device``:
    ``{"tiles", "tile", "blocks"}``, tiles of ``tile`` bins in shared
    memory, each taken by ``blocks`` blocks of 1024 threads.  Asked of the
    CUDA runtime once per device and sizes, then kept."""
    tiles, tile, blocks = _bin_plan(torch.device(device).index or 0, int(n),
                                    int(n_bins))
    return {"tiles": tiles, "tile": tile, "blocks": blocks}


def bin_overlap(starts, ends, origin: int, bin_size: int, n_bins: int):
    """K8 (replaces ``_bin_kernel``): aligned bases per genome bin.  For
    int32 reads ``[starts, ends)`` and the ``n_bins`` contiguous bins of
    ``bin_size`` from ``origin``, ``out[b] = sum(max(min(e, hi_b) -
    max(s, lo_b), 0))``, int64 (n_bins,).  Reads with ``e <= s`` add
    nothing; reads that reach outside the binned range are clipped.

    A read costs at most four updates however many bins it spans: its
    overlaps with its first and last bin, and a difference array of counts
    for the whole bins between them, scanned at the end.  The kernel keeps
    the sums in shared memory, in tiles of the bins
    (:func:`bin_overlap_plan`).  One call is one launch.

    Edges and sums are int64.  The TPU kernel casts the edges to int32 and
    sums in int32, so the two agree wherever neither of those wraps; this
    one equals ``CoverageIndex.bin_histogram`` (reads with ``e >= s``) at
    any size."""
    n = _check_cols("starts, ends", starts, ends)
    origin, bin_size, n_bins = int(origin), int(bin_size), int(n_bins)
    _check_bins(origin, bin_size, n_bins)
    if starts.device.type == "cpu":
        return bin_overlap_torch(starts, ends, origin, bin_size, n_bins)
    out = torch.zeros(n_bins, dtype=torch.int64, device=starts.device)
    if n == 0:
        return out
    _launch("bin_overlap", "coral_bin_overlap", starts,
            starts.data_ptr(), ends.data_ptr(), out.data_ptr(), n, origin,
            bin_size, n_bins, *_bin_plan(starts.device.index or 0, n, n_bins))
    return out


# the (n, n) matrix is n^2 bytes; 2^16 rows are 4 GB
_MATCH_MAX_N = 1 << 16


def _check_match(p1, p2, cutoff: int) -> int:
    n = _check_cols("p1, p2", p1, p2)
    if n > _MATCH_MAX_N:
        raise ValueError(f"{n} positions: at most {_MATCH_MAX_N}")
    if not 0 <= cutoff < 1 << 31:
        raise ValueError(f"cutoff={cutoff} outside 0..2^31-1")
    return n


def match_matrix_torch(p1, p2, cutoff: int):
    """Plain version of K9: uint8 (n, n), differences in int64."""
    _check_match(p1, p2, cutoff)
    a, b = p1.to(torch.int64), p2.to(torch.int64)
    near = ((a[:, None] - a[None, :]).abs() < cutoff) \
        & ((b[:, None] - b[None, :]).abs() < cutoff)
    return near.to(torch.uint8)


def match_matrix(p1, p2, cutoff: int):
    """K9 (replaces ``_match_kernel``): the pairwise match matrix of one
    clustering group, ``M[i, j] = |p1_i - p1_j| < cutoff and |p2_i - p2_j|
    < cutoff`` for int32 positions, any ``n``.  Returns uint8 (n, n) of 0/1
    (the TPU kernel returns int32; callers only ask which cells are
    non-zero).

    The differences are the true ones, as in the host clustering (int64).
    The TPU kernel subtracts in int32, which wraps once two positions are
    2^31 or more apart, possible only with negative positions; there this
    kernel follows the host, not the TPU kernel."""
    cutoff = int(cutoff)
    n = _check_match(p1, p2, cutoff)
    if p1.device.type == "cpu":
        return match_matrix_torch(p1, p2, cutoff)
    out = torch.empty((n, n), dtype=torch.uint8, device=p1.device)
    if n == 0:
        return out
    _launch("match_matrix", "coral_match_matrix", p1,
            p1.data_ptr(), p2.data_ptr(), out.data_ptr(), n, cutoff)
    return out
