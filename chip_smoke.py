#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``coral_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero:

1. environment: torch/CUDA versions, the card's name and power limit,
   ``g++`` and zlib, and the port's own build of its native BAM core
   (required);
2. build: the CUDA kernels of ``coral_tpu_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch version, bit for bit, with CUDA
   event timings: K2 and K6 on pairs whose gates come in BAM order (runs
   of one interval), on pairs whose hits all fall on one interval and at
   8,190 intervals, each beside K1, K5 and K7 on the same columns, then
   three back-to-back calls of each and both on two streams at once; K1,
   K2 and the copy control K7 over the v3 layout and K5, K6 over the v2
   layout at 2^21 pairs and 16 intervals (also against numpy; K5 and K6
   against K1 and K2 on the same pairs), K3 and K4 over the 6-column
   layout at 2^21 pairs with 16 and with 8,200 intervals (and
   K4 ÷ K3), once with every hit on 14 intervals whose slots in K4's bin
   cache collide, K8 at 2^21 reads over 256 and over 65,536 bins, at
   n_bins either side of each switch of its plan on this card, and over
   the reads sorted by start (also against the prefix-sum histogram), the
   floor of one timed call, K9 at 2,048, 1,001 and 4,096 positions;
4. the main paths at WGS scale, on the junction-heavy 10-chromosome
   sample (5,179,920 records, 1.5 M pairs):
   a. reconstruct with the ``cuda`` engine (K1) and the fused batch
      scorer (K2) against the ``numpy`` engine: graph files
      byte-identical, support and coverage exact;
   b. the 6-column route: the sample's amplicon intervals plus 8,190
      decoy intervals that overlap no read, so the ``cuda`` engine goes
      through K3 and the ``cuda6`` batch scorer through K4; hit mask and
      BpTable against the ``numpy`` engine, against K1 on the real
      intervals alone, and again with the decoys placed first;
   c. the v2 route: the sample's pairs through the native ``pack_pairs2``,
      the ``cuda2`` batch scorer (K6) against the ``cuda`` and ``torch``
      engines and K5's hit mask against K1's of 4a;
   d. coverage: the sample's read spans, chromosome by chromosome, through
      ``bin_coverage(engine="cuda")`` (K8) against
      ``CoverageIndex.bin_histogram`` and, on one chromosome, numpy;
   e. clustering: ``cluster_breakpoints(engine="cuda")`` (K9) against
      ``engine="host"`` on the breakpoint rows of the mixed sample and on
      a seeded list with groups of 1,000 to 4,096 members and one past
      the cap: the same clusters, member for member, in order;
5. the full pipeline with cycles on a mixed sample through
   ``python -m coral_tpu_torch reconstruct``, ``cuda`` vs ``numpy``:
   graph and cycles files byte-identical.

The last three lines are the card (``nvidia-smi``), a JSON object with
one entry per kernel, and ``{"ok": true, "device": {...}}``.  Nothing here
imports JAX or the JAX package.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.

A kernel's ``bound_ms`` is the least time the card could take for the same
work: the larger of the bytes it must move (inputs read once, outputs
written once) over 3.35 TB/s and its integer operations over 16.75 T/s
(H100 SXM: 64 int32 lanes on each of 132 SMs, a quarter of the 67 TFLOP/s
float32 rate, which counts 128 lanes and two operations per FMA).  The
operations of K3 and K4 are counted from this run's data: ten per interval
a pair examines before its first side is found, thirty for the rest; those
of K8 likewise: twelve a read and ten per bin that it touches.
"""
from __future__ import annotations

import contextlib
import dataclasses
import filecmp
import json
import os
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N_PAIRS = 1 << 21
N_INT = 16
N_INT_LONG = 8200
N_SUPPORT_BINS = 8190     # the resolved layouts' limit (K2, K6)
N_DECOYS = 8190
# K4 above 8190 intervals keeps a direct-mapped cache of 2048 bins (slot =
# bin % 2048, csrc/pair6.cu): these windows and the last interval (8199,
# slot 7) fall on six slots, three of them shared by three or four bins
HOT_WINDOWS = [3, 3 + 2048, 3 + 4096, 3 + 6144, 100, 100 + 2048, 100 + 4096,
               2047, 2047 + 2048, 2047 + 4096, 2047 + 6144, 1000, 5000]
CUTOFF = 100
MIN_MAPQ = 20
GAP = 100.0
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 16.75e12
OPS_PER_PAIR_V3 = 15      # the decision chain (csrc/pair3.cu)
OPS_PER_PAIR_6COL = 30    # meta decode, gates, reference jump, decision
OPS_PER_INTERVAL = 10     # two sides x (three compares + two ands)
OPS_PER_PAIR_V2 = 30      # meta2 decode, MAPQ gate, reference jump, decision
OPS_PER_READ = 12         # clip to the binned range, first bin (csrc/bins.cu)
OPS_PER_TOUCHED_BIN = 10  # edge, min, difference, atomic, step
OPS_PER_READ_RECOUNTED = 30  # clip, two bins, two partials, merge, counts
OPS_PER_CELL = 9          # two x (min, max, subtract, compare) + and
N_READS = 1 << 21
READ_SPAN = 200_000_000
MATCH_CUTOFF = 2000
COVERAGE_BIN = 100_000    # phase 4d: 1,594 bins a chromosome

KERNELS = {
    "pair3": ("coral_tpu_torch/csrc/pair3.cu",
              "coral_tpu/ops/pallas_kernels.py:378"),
    "pair3_support": ("coral_tpu_torch/csrc/pair3.cu",
                      "coral_tpu/ops/pallas_kernels.py:473"),
    "pair6": ("coral_tpu_torch/csrc/pair6.cu",
              "coral_tpu/ops/pallas_kernels.py:87"),
    "pair6_support": ("coral_tpu_torch/csrc/pair6.cu",
                      "coral_tpu/ops/pallas_kernels.py:659"),
    "stream_control": ("coral_tpu_torch/csrc/pair3.cu",
                       "coral_tpu/ops/pallas_kernels.py:420"),
    "pair2": ("coral_tpu_torch/csrc/pair2.cu",
              "coral_tpu/ops/pallas_kernels.py:238"),
    "pair2_support": ("coral_tpu_torch/csrc/pair2.cu",
                      "coral_tpu/ops/pallas_kernels.py:282"),
    "bin_overlap": ("coral_tpu_torch/csrc/bins.cu",
                    "coral_tpu/ops/pallas_kernels.py:541"),
    "match_matrix": ("coral_tpu_torch/csrc/match.cu",
                     "coral_tpu/ops/pallas_kernels.py:609"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, in ms, with the 50 MB L2 cache
    flushed before each call (the main path finds its columns cold: they
    have just been copied in)."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(n_bytes: int, n_ops: int):
    """(least ms, "bytes" or "operations") for that much traffic and
    integer work on the card."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_v3(n: int, out_bytes: int):
    return bound_ms(12 * n + out_bytes, OPS_PER_PAIR_V3 * n)


def bound_v2(n: int, out_bytes: int):
    return bound_ms(16 * n + out_bytes, OPS_PER_PAIR_V2 * n)


def bound_bins(starts, ends, origin: int, bin_size: int, n_bins: int):
    """Bound of K8 on these reads: 8 B a read and the sums written once;
    the bins each read touches are counted from the reads."""
    lo = np.maximum(starts.astype(np.int64), origin)
    hi = np.minimum(ends.astype(np.int64), origin + bin_size * n_bins)
    live = hi > lo
    touched = int(((hi[live] - 1 - origin) // bin_size
                   - (lo[live] - origin) // bin_size + 1).sum())
    return bound_ms(8 * len(starts) + 8 * n_bins,
                    OPS_PER_READ * len(starts)
                    + OPS_PER_TOUCHED_BIN * touched)


def bound_bins_recounted(n: int, n_bins: int):
    """K8's bound counted from its design (csrc/bins.cu): 8 B a read and
    the sums written once, and a fixed number of operations a read however
    many bins it spans (the clip, two bins, two partials, the merge)."""
    return bound_ms(8 * n + 8 * n_bins, OPS_PER_READ_RECOUNTED * n)


def bound_match(n: int):
    return bound_ms(8 * n + n * n, OPS_PER_CELL * n * n)


def bound_6col(io: np.ndarray, n_int: int, out_bytes: int):
    """Bound of K3/K4 on columns whose first interval of side i is ``io``
    (-1: none, the pair examines the whole table)."""
    n = len(io)
    examined = int(np.where(io >= 0, io.astype(np.int64) + 1, n_int).sum())
    return bound_ms(24 * n + 12 * n_int + out_bytes,
                    OPS_PER_INTERVAL * examined + OPS_PER_PAIR_6COL * n)


# -- inputs ---------------------------------------------------------------

def synth_scoring_batch(n_pairs: int, n_intervals: int = 16, seed: int = 0):
    """The scoring benchmark's random batch (``bench.synth_scoring_batch``):
    14 unpacked pair columns over ``n_intervals`` 2 Mb intervals; sparse
    (about one pair in 10^4 hits)."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, 200_000_000, n_pairs).astype(np.int32)
    ends = (starts + rng.integers(1_000, 60_000, n_pairs)).astype(np.int32)
    cols = dict(
        qi_end=rng.integers(0, 30_000, n_pairs).astype(np.int32),
        qj_start=rng.integers(0, 30_000, n_pairs).astype(np.int32),
        chrom_i=rng.integers(0, 24, n_pairs).astype(np.int32),
        r1_i=rng.integers(0, 200_000_000, n_pairs).astype(np.int32),
        r2_i=rng.integers(0, 200_000_000, n_pairs).astype(np.int32),
        strand_i=rng.choice([-1, 1], n_pairs).astype(np.int32),
        mapq_i=rng.integers(0, 61, n_pairs).astype(np.int32),
        nm_i=(rng.random(n_pairs) * 0.2).astype(np.float32),
        chrom_j=rng.integers(0, 24, n_pairs).astype(np.int32),
        r1_j=rng.integers(0, 200_000_000, n_pairs).astype(np.int32),
        r2_j=rng.integers(0, 200_000_000, n_pairs).astype(np.int32),
        strand_j=rng.choice([-1, 1], n_pairs).astype(np.int32),
        mapq_j=rng.integers(0, 61, n_pairs).astype(np.int32),
        nm_j=(rng.random(n_pairs) * 0.2).astype(np.float32),
    )
    int_chrom = (np.arange(n_intervals) % 24).astype(np.int32)
    int_start = (np.arange(n_intervals) * 3_000_000).astype(np.int32)
    int_end = (int_start + 2_000_000).astype(np.int32)
    return starts, ends, cols, int_chrom, int_start, int_end


def synth_alignment_table(cols: dict):
    """The pair columns interleaved into a flat ALIGNMENT table (pair k =
    alignments 2k, 2k+1), so that they pack through the product's packers
    (``bench.synth_alignment_table``)."""
    n = len(cols["qi_end"])

    def interleave(a, b, dtype):
        out = np.empty(2 * n, dtype)
        out[0::2] = a
        out[1::2] = b
        return out

    zero = np.zeros(n, np.int64)
    return ((2 * np.arange(n)).astype(np.int64),
            interleave(zero, cols["qj_start"], np.int64),
            interleave(cols["qi_end"], zero, np.int64),
            interleave(cols["r1_i"], cols["r1_j"], np.int64),
            interleave(cols["r2_i"], cols["r2_j"], np.int64),
            interleave(cols["chrom_i"], cols["chrom_j"], np.int32),
            interleave(cols["strand_i"], cols["strand_j"], np.int8),
            interleave(cols["mapq_i"], cols["mapq_j"], np.int32))


def dense_case(n: int, n_int: int, seed: int):
    """v3 columns of which about half hit; includes the threshold edges
    (|qgap| a multiple of 5 with |qgap - grr| = |qgap|/5 and +-1), the
    query-gap edges qgap = -cutoff and -cutoff-1, and zero pad rows."""
    rng = np.random.default_rng(seed)
    qgap = rng.integers(-300, 200_000, n).astype(np.int64)
    grr = qgap + rng.integers(-60_000, 60_000, n)
    iogm = rng.integers(-n_int // 3, n_int, n)
    sdiff = rng.integers(0, 2, n)
    k = n // 8
    edge = rng.integers(0, n, k)
    q = 5 * rng.integers(101, 200_000, k) * rng.choice([-1, 1], k)
    qgap[edge] = q
    grr[edge] = q - np.sign(q) * (np.abs(q) // 5 + rng.integers(-1, 2, k)) \
        * rng.choice([-1, 1], k)
    sdiff[edge] = 0
    iogm[edge] = rng.integers(0, n_int, k)
    gapq = rng.integers(0, n, k // 4)
    qgap[gapq] = -CUTOFF - rng.integers(0, 2, len(gapq))
    meta = ((iogm + 1) << 1) | sdiff
    pad = rng.integers(0, n, k // 8)
    meta[pad] = 0
    return [qgap.astype(np.int32), grr.astype(np.int32),
            meta.astype(np.int32)]


def dense_case6(n: int, n_int: int, seed: int, hot=None):
    """An int32 interval table of ``n_int`` rows and 6-column pair columns
    of which about a fifth hit (with ``hot``, a list of window indices, the
    sides fall only in those windows, past every window or on the last
    interval, so the hits fall on at most ``len(hot) + 1`` intervals).
    Intervals 0..n_int-2 are 200 kb windows,
    400 kb apart, on chromosome codes 0..23 in turn; the last interval
    spans all of int32 on code 30.  Rows: both sides in one window, in two
    windows or in none; '-' strand sides stored r1 > r2; MAPQ on both sides
    of the gate; the threshold edges (|qgap| a multiple of 5 with
    |qgap - grr| = |qgap|/5 and +-1, same strand); the query-gap edges; on
    code 30, reference ends and read gaps at the ends of int32, where the
    differences wrap; sides that an earlier window also covers (window 0
    is widened over window 24's place when there is one); zero pad rows.
    Returns ((int_chrom, int_start, int_end), packed columns)."""
    rng = np.random.default_rng(seed)
    i32 = np.iinfo(np.int32)
    k_all = np.arange(n_int)
    ic = (k_all % 24).astype(np.int32)
    is_ = ((k_all // 24) * 400_000).astype(np.int64)
    ie = is_ + 200_000
    ic[-1], is_[-1], ie[-1] = 30, i32.min, i32.max
    n_win = n_int - 1
    if n_win > 24:
        ie[0] = ie[24]            # window 24 lies inside window 0 now

    def side(win):
        """Reference ends inside window ``win`` (-1: past every window),
        '+' strand order."""
        out = win < 0
        w = np.where(out, 0, win)
        lo = np.where(out, 190_000_000, is_[w]) \
            + rng.integers(0, 20_000, len(win))
        return ic[w].astype(np.int64), lo, \
            lo + rng.integers(100, 5_000, len(win))

    if hot is not None:
        win_i = rng.choice(np.append(np.asarray(hot), -1), n)
        win_j = np.where(rng.random(n) < 0.8, win_i, rng.choice(hot, n))
    elif n_win:
        win_i = rng.integers(-max(n_win // 3, 1), n_win, n)
        win_j = np.where(rng.random(n) < 0.8, win_i,
                         rng.integers(-1, n_win, n))
    else:
        win_i = win_j = np.full(n, -1)
    ci, lo_i, hi_i = side(win_i)
    cj, lo_j, hi_j = side(win_j)
    si = rng.choice([-1, 1], n)
    sj = rng.choice([-1, 1], n)
    mapqs, weights = [0, 5, 19, 20, 21, 60, 255], \
        [.02, .03, .05, .1, .1, .65, .05]
    mi = rng.choice(mapqs, n, p=weights)
    mj = rng.choice(mapqs, n, p=weights)
    qgap = rng.integers(-300, 60_000, n)
    k = n // 8
    # threshold edges: same strand '+', r1_j placed so that the reference
    # jump is qgap -+ (|qgap|/5 + {-1, 0, 1})
    edge = rng.integers(0, n, k)
    q = 5 * rng.integers(101, 12_000, k) * rng.choice([-1, 1], k)
    qgap[edge] = q
    si[edge] = sj[edge] = 1
    cj[edge] = ci[edge]
    jump = q - np.sign(q) * (np.abs(q) // 5 + rng.integers(-1, 2, k)) \
        * rng.choice([-1, 1], k)
    lo_j[edge] = hi_i[edge] + jump
    hi_j[edge] = lo_j[edge] + 3_000
    gapq = rng.integers(0, n, k // 4)
    qgap[gapq] = -CUTOFF - rng.integers(0, 2, len(gapq))
    # int32 ends on the all-covering last interval: the differences wrap
    wrap = rng.integers(0, n, max(k // 8, 4))
    ci[wrap] = cj[wrap] = 30
    ends = np.array([i32.min, i32.min + 1, -1, 0, 1, i32.max - 1, i32.max])
    lo_i[wrap] = rng.choice(ends, len(wrap))
    hi_i[wrap] = rng.choice(ends, len(wrap))
    lo_j[wrap] = rng.choice(ends, len(wrap))
    hi_j[wrap] = rng.choice(ends, len(wrap))
    qgap[wrap] = rng.choice(ends, len(wrap))
    mi[wrap] = mj[wrap] = 60
    # storage order: r1 > r2 on the '-' strand (the wrap rows stay as drawn)
    keep = np.ones(n, bool)
    keep[wrap] = False
    flip_i = (si < 0) & keep
    flip_j = (sj < 0) & keep
    r1_i, r2_i = np.where(flip_i, hi_i, lo_i), np.where(flip_i, lo_i, hi_i)
    r1_j, r2_j = np.where(flip_j, hi_j, lo_j), np.where(flip_j, lo_j, hi_j)

    def word(chrom, strand, mapq):
        return ((chrom + 1) << 9) | (mapq << 1) | (strand > 0)

    meta = (word(ci, si, mi) << 14) | word(cj, sj, mj)
    cols = [qgap, r1_i, r2_i, r1_j, r2_j, meta]
    pad = rng.integers(0, n, max(k // 8, 1))
    for c in cols:
        c[pad] = 0
    return ((ic, is_.astype(np.int32), ie.astype(np.int32)),
            [c.astype(np.int32) for c in cols])


def dense_case2(n: int, n_int: int, seed: int):
    """v2 columns (qgap, r2_i, r1_j, meta) of which about half hit: both
    strands on both sides, MAPQ on both sides of the gate (and 0 and 255),
    gate indices from -1 to n_int - 1, the threshold edges (same strand,
    |qgap| a multiple of 5 with the reference jump |qgap|/5 and +-1 away),
    the query-gap edges qgap = -cutoff and -cutoff-1, reference ends and
    read gaps at the ends of int32, where the differences wrap, and zero
    pad rows."""
    rng = np.random.default_rng(seed)
    i32 = np.iinfo(np.int32)
    qgap = rng.integers(-300, 60_000, n).astype(np.int64)
    r2_i = rng.integers(0, 200_000_000, n).astype(np.int64)
    si = rng.choice([-1, 1], n)
    sj = rng.choice([-1, 1], n)
    jump = qgap + rng.integers(-30_000, 30_000, n)
    iog = rng.integers(-n_int // 3, n_int, n)
    mapqs, weights = [0, 5, 19, 20, 21, 60, 255], \
        [.02, .03, .05, .1, .1, .65, .05]
    mi = rng.choice(mapqs, n, p=weights)
    mj = rng.choice(mapqs, n, p=weights)
    k = n // 8
    edge = rng.integers(0, n, k)
    q = 5 * rng.integers(101, 12_000, k) * rng.choice([-1, 1], k)
    qgap[edge] = q
    jump[edge] = q - np.sign(q) * (np.abs(q) // 5 + rng.integers(-1, 2, k)) \
        * rng.choice([-1, 1], k)
    si[edge] = sj[edge]
    iog[edge] = rng.integers(0, n_int, k)
    mi[edge] = mj[edge] = 60
    gapq = rng.integers(0, n, k // 4)
    qgap[gapq] = -CUTOFF - rng.integers(0, 2, len(gapq))
    # the jump is r1_j - r2_i on a '+' side j, r2_i - r1_j on a '-' one
    r1_j = np.where(sj > 0, r2_i + jump, r2_i - jump)
    wrap = rng.integers(0, n, max(k // 8, 4))
    ends = np.array([i32.min, i32.min + 1, -1, 0, 1, i32.max - 1, i32.max])
    for col in (qgap, r2_i, r1_j):
        col[wrap] = rng.choice(ends, len(wrap))
    meta = ((iog + 1) << 18) | (mi << 10) | ((si > 0) << 9) | (mj << 1) \
        | (sj > 0)
    cols = [qgap, r2_i, r1_j, meta]
    pad = rng.integers(0, n, max(k // 8, 1))
    for c in cols:
        c[pad] = 0
    return [c.astype(np.int32) for c in cols]


def v2_to_v3(packed2, min_mapq: int):
    """The same pairs in the v3 layout: what the v3 packer resolves at
    pack time (the MAPQ gate folded into the interval gate, the reference
    jump in wrapping int32), derived from the v2 columns."""
    qgap, r2_i, r1_j, meta = packed2
    iog = ((meta >> 18) & 0x1FFF) - 1
    ok = (((meta >> 10) & 0xFF) >= min_mapq) & (((meta >> 1) & 0xFF)
                                               >= min_mapq)
    plus_i, plus_j = (meta >> 9) & 1, meta & 1
    with np.errstate(over="ignore"):
        grr = np.where(plus_j > 0, r1_j - r2_i, r2_i - r1_j)
    meta3 = ((np.where(ok, iog, -1) + 1) << 1) | (plus_i != plus_j)
    return [qgap, grr.astype(np.int32), meta3.astype(np.int32)]


def ordered_case2(n: int, n_int: int, kind: str, seed: int):
    """``dense_case2``'s pairs with their gates laid out as the support
    kernels meet them on the main path: "BAM order", runs of 20 to 400
    pairs on one gate (no interval, or one of ``n_int``), as pairs of a
    coordinate-sorted BAM come; "one interval", every gate interval 0, so
    every hit falls on one bin."""
    cols = dense_case2(n, n_int, seed)
    rng = np.random.default_rng(seed + 1)
    if kind == "BAM order":
        k = n // 20 + 1
        gate = np.repeat(rng.integers(-1, n_int, k),
                         rng.integers(20, 400, k))[:n]
    else:
        gate = np.zeros(n, np.int64)
    cols[3] = ((cols[3] & ((1 << 18) - 1)) | ((gate + 1) << 18)) \
        .astype(np.int32)
    return cols


def synth_reads(n_reads: int, seed: int = 1):
    """The coverage benchmark's reads (``tools/bench_kernels.py``,
    ``bench_coverage_bins``): int32 spans of 1 to 60 kb over 200 Mb."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, READ_SPAN, n_reads).astype(np.int32)
    ends = (starts + rng.integers(1_000, 60_000, n_reads)).astype(np.int32)
    return starts, ends


def synth_breakpoints(seed: int, group_sizes):
    """A breakpoint list with one clustering group (chromosome pair and
    orientations) of each size in ``group_sizes``, in shuffled order.  In a
    group of m members, junctions lie around 2 + sqrt(m) // 12 sites on
    either side, 5 kb apart, each scattered over 3 kb: with a 2 kb cutoff a
    site pair holds tens of members in a few clusters, and the first-fit
    scan has chains to follow and ties to break."""
    rng = np.random.default_rng(seed)
    bps = []
    for g, m in enumerate(group_sizes):
        sites = 2 + int(m ** 0.5) // 12
        c1, c2 = f"chr{g % 22 + 1}", f"chr{(g // 22) % 22 + 1}"
        o1, o2 = "+-"[(g // 484) % 2], "+-"[(g // 968) % 2]
        p1 = rng.integers(0, sites, m) * 5000 + rng.integers(0, 3000, m)
        p2 = rng.integers(0, sites, m) * 5000 + rng.integers(0, 3000, m)
        bps += [[c1, int(a), o1, c2, int(b), o2, ("rd", g, k), 0, 0, 60, 60]
                for k, (a, b) in enumerate(zip(p1, p2))]
    return [bps[k] for k in rng.permutation(len(bps))]


WGS_CHROMS = [f"chr{i}" for i in range(1, 10)] + ["chrX"]
WGS_CHR_LEN = 159_345_973


def build_wgs_sample(out_dir, read_len, n_junction_reads, junction_flank,
                     bg_cov, name):
    """One simulated ecDNA amplicon replicated onto ten real chromosome
    names (``tools/bench_wgs.build``): only 4-character names can replace
    the template's "chr7" SA rnames in place.  Returns (bam, cns, seeds,
    records)."""
    from coral_tpu_torch.io.bgzf import BGZF_EOF, iter_blocks, write_bgzf
    from coral_tpu_torch.sim import simulate_ecdna

    bam, cns, seeds = simulate_ecdna(
        out_dir, jitter=2, n_junction_reads=n_junction_reads,
        bg_read_len=read_len, amp_read_len=read_len,
        junction_flank=junction_flank, bg_cov=bg_cov)
    with open(bam, "rb") as fh:
        payload = b"".join(b for _, b in iter_blocks(fh.read()))
    l_text = struct.unpack_from("<i", payload, 4)[0]
    p = 8 + l_text
    n_ref = struct.unpack_from("<i", payload, p)[0]
    p += 4
    for _ in range(n_ref):
        p += 8 + struct.unpack_from("<i", payload, p)[0]
    body_start = p
    rel = []
    while p < len(payload):
        rel.append(p - body_start)
        p += 4 + struct.unpack_from("<i", payload, p)[0]
    body = bytearray(payload[body_start:])

    text = ("@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{c}\tLN:{WGS_CHR_LEN}\n" for c in WGS_CHROMS)).encode()
    header = b"BAM\x01" + struct.pack("<i", len(text)) + text \
        + struct.pack("<i", len(WGS_CHROMS))
    for c in WGS_CHROMS:
        nb = c.encode() + b"\x00"
        header += struct.pack("<i", len(nb)) + nb \
            + struct.pack("<i", WGS_CHR_LEN)

    big_path = os.path.join(out_dir, f"{name}.bam")
    with open(big_path, "wb") as fp:
        write_bgzf(fp, bytes(header), level=1)
        for ci, c in enumerate(WGS_CHROMS):
            n0, n1 = 48 + ci // 10, 48 + ci % 10
            for r in rel:
                struct.pack_into("<i", body, r + 4, ci)
                body[r + 36] = n0
                body[r + 37] = n1
            write_bgzf(fp, bytes(body).replace(b"chr7,", f"{c},".encode()),
                       level=1)
        fp.write(BGZF_EOF)

    with open(cns) as fh:
        cns_rows = fh.read().splitlines()[1:]
    cns_path = os.path.join(out_dir, f"{name}.cns")
    with open(cns_path, "w") as fp:
        fp.write("chromosome\tstart\tend\tgene\tlog2\tdepth\n")
        for c in WGS_CHROMS:
            for row in cns_rows:
                fp.write(c + row[row.index("\t"):] + "\n")
    seeds_path = os.path.join(out_dir, f"{name}_seeds.bed")
    with open(seeds_path, "w") as fp:
        for c in WGS_CHROMS:
            fp.write(f"{c}\t55000000\t55399999\n")
    return big_path, cns_path, seeds_path, len(rel) * len(WGS_CHROMS)


def build_junction_heavy(out_dir):
    """The junction-dominated 10-chromosome sample
    (``tools/bench_wgs.build_junction_heavy``): 1.5 M chimeric reads of one
    adjacent pair each over a modest background, 5,179,920 records."""
    return build_wgs_sample(out_dir, read_len=1500, n_junction_reads=150_000,
                            junction_flank=50, bg_cov=4, name="wgs_hvy")


def decoy_intervals(n: int):
    """``n`` intervals that no read of the WGS sample can overlap: half on
    chromosomes the sample does not have, half on chr1 past its end."""
    half = n // 2
    absent = [f"chr{c}" for c in range(11, 23)]
    out = [[absent[k % len(absent)], 1_000_000 + 2_000 * k,
            1_000_000 + 2_000 * k + 1_000, 0] for k in range(half)]
    out += [["chr1", WGS_CHR_LEN + 1_000 + 2_000 * k,
             WGS_CHR_LEN + 2_000 + 2_000 * k, 0] for k in range(n - half)]
    return out


# -- phase 1 --------------------------------------------------------------

def phase_env() -> str:
    import torch

    log(f"[1 env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    smi = nvidia_smi()
    log(f"[1 env] nvidia-smi: {smi}")
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True)
    zlib = subprocess.run(["g++", "-E", "-x", "c++", "-"],
                          input="#include <zlib.h>\n", capture_output=True,
                          text=True)
    log(f"[1 env] {gxx.stdout.splitlines()[0] if gxx.stdout else 'no g++'}; "
        f"zlib.h {'found' if zlib.returncode == 0 else 'MISSING'}")
    from coral_tpu_torch.native import _build, bamcore, walkenum

    t0 = time.perf_counter()
    lib = bamcore._load()
    walkenum._load()
    require(str(_build.library_path("bamcore")) == lib._name,
            f"native BAM core loaded from {lib._name}")
    log(f"[1 env] native host libraries built by g++ from "
        f"coral_tpu_torch/native/*.cpp in {time.perf_counter() - t0:.2f} s: "
        f"{os.path.relpath(lib._name, ROOT)}")
    return smi


# -- phase 2 --------------------------------------------------------------

def phase_build() -> None:
    from coral_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    log(f"[2 build] {path.relative_to(ROOT)} from "
        f"{[str(p.relative_to(ROOT)) for p in _build._sources()[0]]} "
        f"flags {' '.join(_build.NVCC_FLAGS)} in "
        f"{time.perf_counter() - t0:.2f} s")
    logf = path.with_suffix(".log")
    if logf.exists():
        for line in logf.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[2 build] ptxas: {line.strip()}")


# -- phase 3 --------------------------------------------------------------

def _bench_inputs():
    """The benchmark batch packed three ways: (v3 columns, (interval table,
    6 columns), v2 columns)."""
    from coral_tpu_torch.native.bamcore import pack_pairs, pack_pairs2
    from coral_tpu_torch.ops.scoring import pack_pairs3_host

    _, _, cols, ic, is_, ie = synth_scoring_batch(N_PAIRS, N_INT, seed=0)
    table = synth_alignment_table(cols)
    return (pack_pairs3_host(*table, ic, is_, ie, min_mapq=MIN_MAPQ),
            ((ic, is_, ie), pack_pairs(*table)),
            pack_pairs2(*table, ic, is_, ie))


def _row(case, err, kern, plain, bound, plain_reps=30):
    """One kernel's report on one case: its error against the plain version
    and the times of both, measured now."""
    return dict(case=case, max_abs_err=err, ms=cuda_ms(kern),
                plain_ms=cuda_ms(plain, reps=plain_reps, warmup=1),
                bound_ms=bound[0], bound_by=bound[1])


def _log_rows(tag, what, rep):
    log(f"[{tag}] {what}; ms " + " | ".join(
        f"{k} {r['ms']:.4f} plain {r['plain_ms']:.4f} bound "
        f"{r['bound_ms']:.4f} ({r['bound_by']})" for k, r in rep.items()))


def _check_v3(kernels, case, packed, report):
    """K1, K2, K7 against their plain versions and numpy on one v3 case."""
    import torch

    from coral_tpu_torch.ops.scoring import pair_predicate_packed3_np, \
        state_from_numpy

    ic = np.arange(N_INT, dtype=np.int32)
    cols = state_from_numpy(ic, ic, ic, packed, device="cuda").packed
    hit_np, iogm_np = pair_predicate_packed3_np(*packed, CUTOFF, GAP)
    sup_np = np.bincount(iogm_np[hit_np], minlength=N_INT)[:N_INT]
    n = len(packed[0])

    hit_k = kernels.pair3_hitmask(*cols, CUTOFF, GAP)
    hit_p = kernels.pair3_hitmask_torch(*cols, CUTOFF, GAP)
    sup_k = kernels.pair3_support(*cols, N_INT, CUTOFF, GAP)
    sup_p = kernels.pair3_support_torch(*cols, N_INT, CUTOFF, GAP)
    sum_k = kernels.stream_control(*cols)
    sum_p = kernels.stream_control_torch(*cols)
    torch.cuda.synchronize()
    errs = {"pair3": int((hit_k.int() - hit_p.int()).abs().max()),
            "pair3_support": int((sup_k.long() - sup_p.long()).abs().max()),
            "stream_control": int((sum_k.long() - sum_p.long()).abs().max())}
    require(torch.equal(hit_k, hit_p), f"K1 != plain ({case})")
    require(np.array_equal(hit_k.cpu().numpy(), hit_np),
            f"K1 != numpy ({case})")
    require(torch.equal(sup_k, sup_p), f"K2 != plain ({case})")
    require(np.array_equal(sup_k.cpu().numpy(), sup_np),
            f"K2 != numpy bincount ({case})")
    require(torch.equal(sum_k, sum_p), f"K7 != plain ({case})")
    require(np.array_equal(sum_k.cpu().numpy(),
                           packed[0] + packed[1] + packed[2]),
            f"K7 != numpy ({case})")
    fns = {
        "pair3": (lambda: kernels.pair3_hitmask(*cols, CUTOFF, GAP),
                  lambda: kernels.pair3_hitmask_torch(*cols, CUTOFF, GAP),
                  bound_v3(n, n)),
        "pair3_support": (
            lambda: kernels.pair3_support(*cols, N_INT, CUTOFF, GAP),
            lambda: kernels.pair3_support_torch(*cols, N_INT, CUTOFF, GAP),
            bound_v3(n, 4 * N_INT)),
        "stream_control": (lambda: kernels.stream_control(*cols),
                           lambda: kernels.stream_control_torch(*cols),
                           bound_ms(12 * n + 4 * n, 2 * n)),
    }
    for name, (kern, plain, bound) in fns.items():
        report[name] = _row(f"{case}, {n} pairs, {N_INT} intervals",
                            errs[name], kern, plain, bound)
    ms = {k: report[k]["ms"] for k in fns}
    _log_rows("3 kernels", f"v3 {case}: n={n} n_int={N_INT} "
              f"hits={int(hit_np.sum())} K1==plain==numpy K2==plain==numpy "
              f"K7==plain==numpy", report)
    log(f"[3 kernels] v3 {case}: K1/K7 "
        f"{ms['pair3'] / ms['stream_control']:.3f} K2/K7 "
        f"{ms['pair3_support'] / ms['stream_control']:.3f} K2/K1 "
        f"{ms['pair3_support'] / ms['pair3']:.3f}")


def check_v2(kernels, case, packed, n_int, report, tag="3 kernels"):
    """K5 and K6 against their plain versions and numpy on one v2 case, and
    against K1 and K2 on the same pairs in the v3 layout; fills ``report``
    and returns K5's hit mask (numpy)."""
    import torch

    from coral_tpu_torch.ops.scoring import pair_predicate_packed2_np

    cols = [torch.from_numpy(c).cuda() for c in packed]
    cols3 = [torch.from_numpy(c).cuda() for c in v2_to_v3(packed, MIN_MAPQ)]
    args = (*cols, CUTOFF, MIN_MAPQ, GAP)
    sargs = (*cols, n_int, CUTOFF, MIN_MAPQ, GAP)
    n = len(packed[0])

    hit_k, iog_k = kernels.pair2_hitmask(*args)
    hit_p, iog_p = kernels.pair2_hitmask_torch(*args)
    sup_k = kernels.pair2_support(*sargs)
    sup_p = kernels.pair2_support_torch(*sargs)
    hit_1 = kernels.pair3_hitmask(*cols3, CUTOFF, GAP)
    sup_2 = kernels.pair3_support(*cols3, n_int, CUTOFF, GAP)
    torch.cuda.synchronize()
    errs = {"pair2": max(int((hit_k.int() - hit_p.int()).abs().max()),
                         int((iog_k.long() - iog_p.long()).abs().max())),
            "pair2_support": int((sup_k.long() - sup_p.long()).abs().max())}
    require(torch.equal(hit_k, hit_p), f"K5 hit != plain ({case})")
    require(torch.equal(iog_k, iog_p), f"K5 iog != plain ({case})")
    require(torch.equal(sup_k, sup_p), f"K6 != plain ({case})")
    require(torch.equal(hit_k, hit_1), f"K5 hit != K1 ({case})")
    require(torch.equal(sup_k, sup_2), f"K6 != K2 ({case})")
    # numpy's threshold is float64: it may part from the kernels' float32
    # one on the rows at the ends of int32, nowhere else
    hit_np, iog_np = pair_predicate_packed2_np(*packed, CUTOFF, MIN_MAPQ, GAP)
    rows = np.abs(packed[0].astype(np.int64)) < 1 << 24
    hit = hit_k.cpu().numpy()
    require(np.array_equal(hit[rows], hit_np[rows]), f"K5 != numpy ({case})")
    require(np.array_equal(iog_k.cpu().numpy(), iog_np),
            f"K5 iog != numpy ({case})")
    what = f"{case}, {n} pairs, {n_int} intervals"
    rep = {
        "pair2": _row(what, errs["pair2"],
                      lambda: kernels.pair2_hitmask(*args),
                      lambda: kernels.pair2_hitmask_torch(*args),
                      bound_v2(n, 5 * n)),
        "pair2_support": _row(what, errs["pair2_support"],
                              lambda: kernels.pair2_support(*sargs),
                              lambda: kernels.pair2_support_torch(*sargs),
                              bound_v2(n, 4 * n_int))}
    for name, r in rep.items():
        report[name].append(r)
    _log_rows(tag, f"v2 {what}: hits={int(hit.sum())} K5==plain==numpy==K1 "
              f"K6==plain==K2", rep)
    log(f"[{tag}] v2 {case}: K6/K5 "
        f"{rep['pair2_support']['ms'] / rep['pair2']['ms']:.3f}")
    return hit


def check_support(kernels, case, packed2, n_int, report):
    """K6 and K2 against their plain versions on one v2 case and its v3
    twin, with K5, K1 and K7 timed on the same columns as the sticks they
    are read against; fills ``report`` (K2, K6)."""
    import torch

    cols = [torch.from_numpy(c).cuda() for c in packed2]
    cols3 = [torch.from_numpy(c).cuda() for c in v2_to_v3(packed2, MIN_MAPQ)]
    sargs = (*cols, n_int, CUTOFF, MIN_MAPQ, GAP)
    n = len(packed2[0])
    sup6 = kernels.pair2_support(*sargs)
    sup2 = kernels.pair3_support(*cols3, n_int, CUTOFF, GAP)
    want = kernels.pair2_support_torch(*sargs)
    torch.cuda.synchronize()
    require(torch.equal(sup6, want), f"K6 != plain ({case})")
    require(torch.equal(sup2, want), f"K2 != plain ({case})")
    what = f"{case}, {n} pairs, {n_int} intervals"
    rep = {
        "pair3_support": _row(
            what, int((sup2.long() - want.long()).abs().max()),
            lambda: kernels.pair3_support(*cols3, n_int, CUTOFF, GAP),
            lambda: kernels.pair3_support_torch(*cols3, n_int, CUTOFF, GAP),
            bound_v3(n, 4 * n_int)),
        "pair2_support": _row(
            what, int((sup6.long() - want.long()).abs().max()),
            lambda: kernels.pair2_support(*sargs),
            lambda: kernels.pair2_support_torch(*sargs),
            bound_v2(n, 4 * n_int))}
    for name, r in rep.items():
        report[name].append(r)
    ms = {"K1": cuda_ms(lambda: kernels.pair3_hitmask(*cols3, CUTOFF, GAP)),
          "K7": cuda_ms(lambda: kernels.stream_control(*cols3)),
          "K5": cuda_ms(lambda: kernels.pair2_hitmask(*cols, CUTOFF,
                                                      MIN_MAPQ, GAP))}
    k2, k6 = rep["pair3_support"]["ms"], rep["pair2_support"]["ms"]
    _log_rows("3 kernels", f"support {what}: hits={int(want.sum())} bins "
              f"hit={int((want > 0).sum())} K2==K6==plain", rep)
    log(f"[3 kernels] support {case}: ms K1 {ms['K1']:.4f} K5 "
        f"{ms['K5']:.4f} K7 {ms['K7']:.4f}; K2/K1 {k2 / ms['K1']:.3f} "
        f"K2/K7 {k2 / ms['K7']:.3f} K6/K5 {k6 / ms['K5']:.3f}")


def check_support_streams(kernels, packed2):
    """K2 and K6 three times back to back, then on two streams at once:
    every call equals the plain version (each output is zeroed on its
    call's stream, into memory the caching allocator hands back as it
    was)."""
    import torch

    cols = [torch.from_numpy(c).cuda() for c in packed2]
    cols3 = [torch.from_numpy(c).cuda() for c in v2_to_v3(packed2, MIN_MAPQ)]
    wants = {k: kernels.pair2_support_torch(*cols, k, CUTOFF, MIN_MAPQ, GAP)
             for k in (N_INT, N_SUPPORT_BINS)}
    calls = {"K2": lambda k: kernels.pair3_support(*cols3, k, CUTOFF, GAP),
             "K6": lambda k: kernels.pair2_support(*cols, k, CUTOFF,
                                                   MIN_MAPQ, GAP)}
    got = [(name, k, call(k)) for name, call in calls.items()
           for k in (N_INT,) * 3 + (N_SUPPORT_BINS,) * 3]
    torch.cuda.synchronize()
    for name, k, g in got:
        require(torch.equal(g, wants[k]),
                f"{name} back to back, {k} intervals != plain")
    streams = [torch.cuda.Stream() for _ in calls]
    got = []
    for _ in range(3):
        for st, (name, call) in zip(streams, calls.items()):
            with torch.cuda.stream(st):
                got.append((name, call(N_INT)))
    torch.cuda.synchronize()
    for name, g in got:
        require(torch.equal(g, wants[N_INT]), f"{name} on two streams "
                "!= plain")
    log(f"[3 kernels] support: K2, K6 x3 back to back at {N_INT} and "
        f"{N_SUPPORT_BINS} intervals, then K2 and K6 on two streams at once "
        f"x3: all == plain")


def check_bins(kernels, case, starts, ends, origin, bin_size, n_bins, report,
               tag="3 kernels"):
    """K8 against its plain version and the prefix-sum histogram on one
    set of reads; fills ``report`` and returns the histogram (numpy)."""
    import torch

    from coral_tpu_torch.ops.coverage import CoverageIndex

    s = torch.from_numpy(starts).cuda()
    e = torch.from_numpy(ends).cuda()
    args = (s, e, origin, bin_size, n_bins)
    got = kernels.bin_overlap(*args)
    want = kernels.bin_overlap_torch(*args)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    require(torch.equal(got, want), f"K8 != plain ({case})")
    hist = got.cpu().numpy()
    index = CoverageIndex(starts, ends, device="cuda")
    require(np.array_equal(hist, index.bin_histogram(origin, bin_size,
                                                     n_bins)),
            f"K8 != CoverageIndex.bin_histogram ({case})")
    plan = kernels.bin_overlap_plan(len(starts), n_bins, "cuda")
    what = f"{case}, {len(starts)} reads, {n_bins} bins of {bin_size}"
    rep = {"bin_overlap": _row(
        what, err, lambda: kernels.bin_overlap(*args),
        lambda: kernels.bin_overlap_torch(*args),
        bound_bins(starts, ends, origin, bin_size, n_bins), plain_reps=5)}
    report["bin_overlap"].append(rep["bin_overlap"])
    recount, by = bound_bins_recounted(len(starts), n_bins)
    _log_rows(tag, f"bins {what}, plan {plan}: "
              f"bases={int(hist.sum())} K8==plain==prefix sums", rep)
    log(f"[{tag}] bins {case}: bound recounted for at most four updates a "
        f"read {recount:.4f} ms ({by}); K8 / bound "
        f"{rep['bin_overlap']['ms'] / rep['bin_overlap']['bound_ms']:.1f}x, "
        f"/ recounted {rep['bin_overlap']['ms'] / recount:.1f}x")
    return hist


def bin_switches(kernels, n: int):
    """The n_bins at and on either side of the switch of K8's plan for
    ``n`` reads on this card, where the bins stop fitting one tile of
    shared memory."""
    lo, hi = 1, 1 << 20
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if kernels.bin_overlap_plan(n, mid, "cuda")["tiles"] > 1:
            hi = mid
        else:
            lo = mid
    return [hi - 1, hi, hi + 1]


def check_match(kernels, case, p1, p2, cutoff, report, tag="3 kernels"):
    """K9 against its plain version on one group's positions."""
    import torch

    a, b = torch.from_numpy(p1).cuda(), torch.from_numpy(p2).cuda()
    got = kernels.match_matrix(a, b, cutoff)
    want = kernels.match_matrix_torch(a, b, cutoff)
    torch.cuda.synchronize()
    err = int((got.int() - want.int()).abs().max())
    require(torch.equal(got, want), f"K9 != plain ({case})")
    n = len(p1)
    what = f"{case}, {n} positions, cutoff {cutoff}"
    rep = {"match_matrix": _row(
        what, err, lambda: kernels.match_matrix(a, b, cutoff),
        lambda: kernels.match_matrix_torch(a, b, cutoff), bound_match(n))}
    report["match_matrix"].append(rep["match_matrix"])
    t0 = time.perf_counter()
    host = got.cpu()
    t_copy = time.perf_counter() - t0
    _log_rows(tag, f"match {what}: cells set={int(host.sum())} K9==plain; "
              f"copy of the {n * n} B matrix to the host "
              f"{t_copy * 1e3:.3f} ms", rep)


def check_6col(kernels, case, ints, packed, report, plain_reps=30,
               tag="3 kernels"):
    """K3 and K4 against their plain versions on one 6-column case; fills
    ``report`` and returns the kernel's hit mask (numpy)."""
    import torch

    from coral_tpu_torch.ops.scoring import state_from_numpy

    st = state_from_numpy(*ints, packed, device="cuda")
    args = (st.int_chrom, st.int_start, st.int_end, *st.packed)
    kw = dict(cutoff=CUTOFF, min_mapq=MIN_MAPQ, gap_=GAP)
    n, n_int = len(packed[0]), len(ints[0])

    hit_k, io_k = kernels.pair6_hitmask(*args, **kw)
    hit_p, io_p = kernels.pair6_hitmask_torch(*args, **kw)
    sup_k = kernels.pair6_support(*args, **kw)
    sup_p = kernels.pair6_support_torch(*args, **kw)
    torch.cuda.synchronize()
    errs = {"pair6": max(int((hit_k.int() - hit_p.int()).abs().max()),
                         int((io_k.long() - io_p.long()).abs().max())),
            "pair6_support": int((sup_k.long() - sup_p.long()).abs().max())}
    require(torch.equal(hit_k, hit_p), f"K3 hit != plain ({case})")
    require(torch.equal(io_k, io_p), f"K3 io != plain ({case})")
    require(torch.equal(sup_k, sup_p), f"K4 != plain ({case})")
    require(int(sup_k.sum()) == int(hit_k.sum()),
            f"K4 counts do not add up to K3's hits ({case})")
    io = io_k.cpu().numpy()
    fns = {
        "pair6": (lambda: kernels.pair6_hitmask(*args, **kw),
                  lambda: kernels.pair6_hitmask_torch(*args, **kw),
                  bound_6col(io, n_int, 5 * n)),
        "pair6_support": (lambda: kernels.pair6_support(*args, **kw),
                          lambda: kernels.pair6_support_torch(*args, **kw),
                          bound_6col(io, n_int, 4 * n_int)),
    }
    for name, (kern, plain, bound) in fns.items():
        report[name] = _row(f"{case}, {n} pairs, {n_int} intervals",
                            errs[name], kern, plain, bound, plain_reps)
    sup = sup_k.cpu().numpy()
    _log_rows(tag, f"6-column {case}: n={n} n_int={n_int} "
              f"hits={int(hit_k.sum())} found_i={int((io >= 0).sum())} "
              f"bins hit={int((sup > 0).sum())} K3==plain K4==plain", report)
    log(f"[{tag}] 6-column {case}: K4/K3 "
        f"{report['pair6_support']['ms'] / report['pair6']['ms']:.3f}")
    return hit_k.cpu().numpy()


def phase_kernels() -> dict:
    """Every kernel against its plain version.  Returns name -> list of
    per-case reports; the result line carries the last case of each."""
    import torch

    from coral_tpu_torch.ops import kernels
    from coral_tpu_torch.ops.scoring import pair_predicate_packed_np

    bench3, (bench_ints, bench6), bench2 = _bench_inputs()
    reports = {k: [] for k in KERNELS}
    require(all(np.array_equal(a, b) for a, b in
                zip(v2_to_v3(bench2, MIN_MAPQ), bench3)),
            "bench batch: v3 columns derived from v2 != packed v3")

    def keep(rep):
        for name, r in rep.items():
            reports[name].append(r)

    # K2 and K6 where the main path's gates put them, and at the layouts'
    # limit; before the cases whose rows the result line carries
    for case, n_int, packed2 in (
            ("BAM order", N_INT,
             ordered_case2(N_PAIRS, N_INT, "BAM order", seed=29)),
            ("one interval", N_INT,
             ordered_case2(N_PAIRS, N_INT, "one interval", seed=31)),
            ("dense", N_SUPPORT_BINS,
             dense_case2(N_PAIRS, N_SUPPORT_BINS, seed=37))):
        check_support(kernels, case, packed2, n_int, reports)
    check_support_streams(kernels, dense_case2(N_PAIRS, N_SUPPORT_BINS,
                                               seed=41))
    for case, packed in (("bench", bench3),
                         ("dense", dense_case(N_PAIRS, N_INT, seed=7))):
        rep = {}
        _check_v3(kernels, case, packed, rep)
        keep(rep)
    for case, ints, packed, reps in (
            ("bench", bench_ints, bench6, 30),
            ("dense", *dense_case6(N_PAIRS, N_INT, seed=11), 30),
            ("dense", *dense_case6(N_PAIRS, N_INT_LONG, seed=13), 2),
            ("hot bins, colliding cache slots",
             *dense_case6(N_PAIRS, N_INT_LONG, seed=19, hot=HOT_WINDOWS),
             2)):
        rep = {}
        hit = check_6col(kernels, case, ints, packed, rep, plain_reps=reps)
        keep(rep)
        if len(ints[0]) == N_INT:
            # the host numpy predicate on the same columns (16 intervals:
            # its (pairs, intervals) mask is affordable), but for the rows
            # at the ends of int32 (chromosome code 30), where its float64
            # threshold and the kernels' float32 one may part
            want, _ = pair_predicate_packed_np(*packed, *ints, CUTOFF,
                                               MIN_MAPQ, GAP)
            rows = (packed[5] >> 23) != 31
            require(np.array_equal(hit[rows], want[rows]),
                    f"K3 != numpy ({case})")
    for case, packed in (("bench", bench2),
                         ("dense", dense_case2(N_PAIRS, N_INT, seed=17))):
        check_v2(kernels, case, packed, N_INT, reports)
    starts, ends = synth_reads(N_READS)
    order = np.argsort(starts, kind="stable")
    sorted_reads = starts[order], ends[order]
    switches = bin_switches(kernels, N_READS)
    log(f"[3 kernels] K8 plan switches for {N_READS} reads: n_bins "
        f"{switches}")
    for n_bins in (256, 1 << 16, *switches):
        check_bins(kernels, "bench", starts, ends, 0, READ_SPAN // n_bins,
                   n_bins, reports)
    for n_bins in (256, 1 << 16):
        check_bins(kernels, "bench sorted by start", *sorted_reads, 0,
                   READ_SPAN // n_bins, n_bins, reports)
    floor = torch.zeros(1, dtype=torch.int64, device="cuda")
    log(f"[3 kernels] the floor of a call, one kernel that zeroes 8 B, "
        f"timed as every kernel here: {cuda_ms(floor.zero_):.4f} ms")
    rng = np.random.default_rng(2)
    for n in (2048, 1001, 4096):
        check_match(kernels, "bench",
                    rng.integers(0, 1_000_000, n).astype(np.int32),
                    rng.integers(0, 1_000_000, n).astype(np.int32),
                    MATCH_CUTOFF, reports)
    return reports


# -- phase 4 --------------------------------------------------------------

def _staged(bam_path, cns, seeds, prefix, cfg, device):
    """reconstruct_graphs (graph files, no breakpoint-only output), stage
    by stage with the time of each."""
    import torch

    from coral_tpu_torch.graph.breakpoint_graph import write_graph_file
    from coral_tpu_torch.io.bam import BamFile
    from coral_tpu_torch.reconstruct import Reconstruction

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    stages = {}
    t_all = t0 = time.perf_counter()
    rec = Reconstruction(BamFile(bam_path), seeds, cfg, device=device)
    rec.read_cns(cns)
    rec.collect()
    stages["scan+collect"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec.hash_to_segments()
    rec.find_amplicon_intervals()
    stages["interval_search"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec.find_smalldel_breakpoints()
    rec.find_breakpoints()
    sync()
    stages["breakpoints"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec.build_graph()
    rec.assign_cov()
    rec.compute_cn()
    for gi, g in enumerate(rec.graphs):
        write_graph_file(g, f"{prefix}_amplicon{gi + 1}_graph.txt")
    stages["graph+cn+write"] = time.perf_counter() - t0
    stages["total"] = time.perf_counter() - t_all
    return rec, stages


def _interval_arrays(intervals, span=0):
    """Interval list -> (chrom codes, starts, ends); with ``span`` the
    bounds move onto one linear genome coordinate."""
    from coral_tpu_torch.constants import CHR_IDX

    ic = np.asarray([CHR_IDX.get(iv[0], -2) for iv in intervals], np.int32)
    is_ = np.asarray([iv[1] for iv in intervals], np.int64)
    ie = np.asarray([iv[2] for iv in intervals], np.int64)
    return ic, is_ + ic * span, ie + ic * span


def _read_spans(bam, span):
    """Every mapped record's aligned span on the linear coordinate."""
    from coral_tpu_torch.constants import CHR_IDX

    code = np.asarray([CHR_IDX.get(r[0], -1) for r in bam.references],
                      np.int64)
    mapped = bam.ref_id >= 0
    base = code[bam.ref_id[mapped]] * span
    return base + bam.pos[mapped], base + bam.end[mapped]


def _coverage_numpy(starts, ends, is_, ie):
    s64, e64 = np.sort(starts), np.sort(ends)
    sc = np.concatenate([[0], np.cumsum(s64)])
    ec = np.concatenate([[0], np.cumsum(e64)])

    def p(x):
        ns = np.searchsorted(s64, x, side="right")
        ne = np.searchsorted(e64, x, side="right")
        return (x * ns - sc[ns]) - (x * ne - ec[ne])

    return p(ie) - p(is_)


def phase_main_path(work: str):
    """4a: the reconstruct main path (K1, K2).  Returns (the cuda run's
    Reconstruction, its launch counts, K1/K2 errors at the path's own
    shape, the scoring inputs phase 4b goes on with)."""
    import torch

    from coral_tpu_torch.config import DEFAULT_CONFIG
    from coral_tpu_torch.ops import kernels
    from coral_tpu_torch.ops.pairs import adjacent_pair_indices, \
        build_chimera_table, last_route_seq, route_records_since
    from coral_tpu_torch.ops.scoring import make_batch_scorer, \
        pack_pairs3_host, pair_predicate_packed3_np, state_from_numpy

    t0 = time.perf_counter()
    bam, cns, seeds, n_rec = build_junction_heavy(work)
    log(f"[4 wgs] junction-heavy sample: {n_rec} records built in "
        f"{time.perf_counter() - t0:.1f} s")

    def cfg(engine):
        return DEFAULT_CONFIG.replace(engine=dataclasses.replace(
            DEFAULT_CONFIG.engine, engine=engine))

    # the main path's run: counters from zero, nothing else launches
    seq = last_route_seq()
    kernels.reset_launches()
    rec_c, st_c = _staged(bam, cns, seeds, os.path.join(work, "cuda"),
                          cfg("cuda"), "cuda")
    table = build_chimera_table(rec_c.chimeras)
    pi, _ = adjacent_pair_indices(table.read_off)
    span = np.int64(1) << 32
    ic, is_, ie = _interval_arrays(rec_c.amplicon_intervals)
    packed = pack_pairs3_host(pi, table.q_start, table.q_end, table.r1,
                              table.r2, table.chrom, table.strand,
                              table.mapq, ic, is_, ie, min_mapq=MIN_MAPQ)
    _, lin_s, lin_e = _interval_arrays(rec_c.amplicon_intervals, span)
    starts, ends = _read_spans(rec_c.bam, span)
    t0 = time.perf_counter()
    build_tables, score = make_batch_scorer(ic, lin_s, lin_e, "cuda",
                                            device="cuda")
    support, cov = score(build_tables(starts, ends), *packed)
    support, cov = support.cpu().numpy(), cov.cpu().numpy()
    t_score = time.perf_counter() - t0
    # the copy control, once, on the path's own columns: the stick that
    # K1 and K2 are read against at this shape (ratios below)
    cols = state_from_numpy(ic, is_, ie, packed, device="cuda").packed
    control = kernels.stream_control(*cols)
    launches = dict(kernels.LAUNCHES)
    routes = route_records_since(seq)

    # the kernels at the main path's shape against their plain versions
    # (after the counts were read: these launches are not the main path's)
    hit_k = kernels.pair3_hitmask(*cols, CUTOFF, GAP)
    hit_p = kernels.pair3_hitmask_torch(*cols, CUTOFF, GAP)
    sup_k = kernels.pair3_support(*cols, len(ic), CUTOFF, GAP)
    sup_p = kernels.pair3_support_torch(*cols, len(ic), CUTOFF, GAP)
    torch.cuda.synchronize()
    errs = {"pair3": int((hit_k.int() - hit_p.int()).abs().max()),
            "pair3_support": int((sup_k.long() - sup_p.long()).abs().max())}
    errs["stream_control"] = int(
        (control.long() - kernels.stream_control_torch(*cols).long())
        .abs().max())
    require(torch.equal(hit_k, hit_p), "WGS shape: K1 != plain")
    require(torch.equal(sup_k, sup_p), "WGS shape: K2 != plain")
    require(errs["stream_control"] == 0, "WGS shape: K7 != plain")
    ms = {"K1": cuda_ms(lambda: kernels.pair3_hitmask(*cols, CUTOFF, GAP)),
          "K2": cuda_ms(lambda: kernels.pair3_support(*cols, len(ic), CUTOFF,
                                                      GAP)),
          "K7": cuda_ms(lambda: kernels.stream_control(*cols))}

    rec_n, st_n = _staged(bam, cns, seeds, os.path.join(work, "numpy"),
                          cfg("numpy"), "cuda")
    rec_n.bam.close()
    n_pairs = routes[0].n_pairs if routes else 0
    require(routes and routes[0].engine == "cuda",
            f"main path did not route to cuda: {routes}")
    require(launches["pair3"] > 0, f"K1 never launched: {launches}")
    require(launches["pair3_support"] > 0, f"K2 never launched: {launches}")
    graphs = sorted(f for f in os.listdir(work)
                    if f.startswith("cuda_") and f.endswith("_graph.txt"))
    require(len(graphs) == len(rec_c.graphs) > 0, "no graph files")
    for f in graphs:
        require(filecmp.cmp(os.path.join(work, f),
                            os.path.join(work, "numpy" + f[4:]),
                            shallow=False), f"{f}: cuda != numpy")
    hit, iogm = pair_predicate_packed3_np(*packed, CUTOFF, GAP)
    require(np.array_equal(
        support, np.bincount(iogm[hit], minlength=len(ic))[:len(ic)]),
        "WGS support != numpy")
    require(np.array_equal(cov, _coverage_numpy(starts, ends, lin_s, lin_e)),
            "WGS coverage != numpy")
    fmt = {k: round(v, 3) for k, v in st_c.items()}
    log(f"[4a wgs] records {n_rec} chimeric pairs {n_pairs} amplicons "
        f"{len(rec_c.graphs)} graph files identical cuda==numpy")
    log(f"[4a wgs] stages s, engine cuda: {json.dumps(fmt)}; pair scoring "
        f"{routes[0].seconds:.3f} s")
    log(f"[4a wgs] stages s, engine numpy: "
        f"{json.dumps({k: round(v, 3) for k, v in st_n.items()})}")
    log(f"[4a wgs] batch scorer (K2 + int64 coverage) over {len(packed[0])} "
        f"pairs, {len(starts)} reads, {len(ic)} intervals: {t_score:.3f} s, "
        f"support {support.tolist()} == numpy, coverage exact")
    log(f"[4a wgs] K1, K2, K7 == plain at the main path's shape "
        f"({len(cols[0])} pairs, {len(ic)} intervals); ms K1 {ms['K1']:.4f} "
        f"K2 {ms['K2']:.4f} K7 {ms['K7']:.4f}; K1/K7 "
        f"{ms['K1'] / ms['K7']:.3f} K2/K7 {ms['K2'] / ms['K7']:.3f} K2/K1 "
        f"{ms['K2'] / ms['K1']:.3f}")
    log(f"[4a wgs] launches in the main path's run: {launches}")
    scoring = dict(table=table, pi=pi, starts=starts, ends=ends, span=span,
                   hit_v3=hit_k.cpu().numpy(), support_v3=support, cov_v3=cov)
    return rec_c, launches, errs, scoring


def _unpacked_columns(table, pi, span):
    """The 14 unpacked columns (``COL_ORDER``) of the pairs (pi, pi + 1) on
    the linear coordinate, NM gate off: what the ``torch`` engine takes."""
    from coral_tpu_torch.ops.scoring import COL_ORDER

    pj = pi + 1
    base_i = table.chrom[pi].astype(np.int64) * span
    base_j = table.chrom[pj].astype(np.int64) * span
    nm = np.zeros(len(pi), np.float32)
    cols14 = dict(
        qi_end=table.q_end[pi], qj_start=table.q_start[pj],
        chrom_i=table.chrom[pi], r1_i=table.r1[pi] + base_i,
        r2_i=table.r2[pi] + base_i,
        strand_i=table.strand[pi].astype(np.int32), mapq_i=table.mapq[pi],
        nm_i=nm, chrom_j=table.chrom[pj], r1_j=table.r1[pj] + base_j,
        r2_j=table.r2[pj] + base_j,
        strand_j=table.strand[pj].astype(np.int32), mapq_j=table.mapq[pj],
        nm_j=nm)
    return [cols14[k] for k in COL_ORDER]


@contextlib.contextmanager
def recorded_hit_masks(pairs_mod, into: list):
    """While active, every hit mask that ``score_pairs_l`` returns (inside
    ``find_breakpoints_device`` too) is appended to ``into``."""
    inner = pairs_mod.score_pairs_l

    def recording(*args, **kw):
        out = inner(*args, **kw)
        into.append(out[2])
        return out

    pairs_mod.score_pairs_l = recording
    try:
        yield
    finally:
        pairs_mod.score_pairs_l = inner


def _bp_tables_equal(a, b) -> bool:
    cols = ("c1", "p1", "s1", "c2", "p2", "s2", "ridx", "ti", "tj", "rgap",
            "flip", "q1", "q2")
    return all(np.array_equal(getattr(a, c), getattr(b, c)) for c in cols) \
        and a.tup == b.tup and a.names == b.names


def phase_six_column_path(rec, scoring, report):
    """4b: the 6-column path.  ``find_breakpoints_device(engine="cuda")``
    and ``make_batch_scorer(engine="cuda6")`` on the whole WGS sample over
    more than 8190 intervals.  Returns the launch counts of that run."""
    import torch

    from coral_tpu_torch.native.bamcore import pack_pairs
    from coral_tpu_torch.ops import kernels
    from coral_tpu_torch.ops import pairs as pairs_mod
    from coral_tpu_torch.ops.scoring import MAX_PACKED2_INTERVALS, \
        make_batch_scorer

    cfg_b = rec.cfg.bp
    real = [list(iv) for iv in rec.amplicon_intervals]
    decoys = decoy_intervals(N_DECOYS)
    table, pi, span = scoring["table"], scoring["pi"], scoring["span"]
    require(len(real) + len(decoys) > MAX_PACKED2_INTERVALS,
            "interval list not past the v3 limit")

    def extract(intervals, engine):
        masks = []
        t0 = time.perf_counter()
        with recorded_hit_masks(pairs_mod, masks):
            tb = pairs_mod.find_breakpoints_device(
                rec.chimeras, intervals, cfg_b.min_bp_match_cutoff,
                cfg_b.min_mapq, 100, cfg_b.gap_mapq, None, engine=engine,
                as_table=True, device="cuda")
        torch.cuda.synchronize()
        require(len(masks) == 1, f"{len(masks)} scoring calls")
        return tb, masks[0], time.perf_counter() - t0

    # this path's run: counters from zero
    seq = pairs_mod.last_route_seq()
    kernels.reset_launches()
    last = real + decoys
    tb_c, hit_c, t_c = extract(last, "cuda")
    ic, is_, ie = _interval_arrays(last)
    packed6 = pack_pairs(pi, table.q_start, table.q_end, table.r1, table.r2,
                         table.chrom, table.strand, table.mapq)
    _, lin_s, lin_e = _interval_arrays(last, span)
    # linear bounds: the coverage query reads all 64 bits, the kernel the
    # low 32, which are the chromosome's own coordinates (span is 2^32)
    t0 = time.perf_counter()
    build6, score6 = make_batch_scorer(ic, lin_s, lin_e, "cuda6",
                                       device="cuda")
    sup6, cov6 = score6(build6(scoring["starts"], scoring["ends"]), *packed6)
    sup6, cov6 = sup6.cpu().numpy(), cov6.cpu().numpy()
    t_score6 = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    routes = pairs_mod.route_records_since(seq)
    require(routes and routes[0].engine == "cuda",
            f"6-column path did not route to cuda: {routes}")
    require(launches["pair6"] >= 1, f"K3 never launched: {launches}")
    require(launches["pair6_support"] >= 1, f"K4 never launched: {launches}")
    require(launches["pair3"] == 0, f"K1 ran on the long list: {launches}")

    # -- against the numpy engine on the same list
    tb_n, hit_n, t_n = extract(last, "numpy")
    require(np.array_equal(hit_c, hit_n), "long list: cuda hit mask != numpy")
    require(_bp_tables_equal(tb_c, tb_n), "long list: cuda BpTable != numpy")
    # -- against the v3 route (K1) on the real intervals alone
    require(np.array_equal(hit_c, scoring["hit_v3"]),
            "long list: K3 hit mask != K1 on the real intervals")
    # -- decoys first: indices shift, hits do not
    tb_f, hit_f, t_f = extract(decoys + real, "cuda")
    require(np.array_equal(hit_f, hit_c), "decoys first: hit mask moved")
    require(_bp_tables_equal(tb_f, tb_c), "decoys first: BpTable moved")
    # -- the batch scorer: cuda6 == cuda on the real intervals, == torch on
    #    the long list (14 unpacked columns, linear coordinates)
    require(np.array_equal(sup6[:len(real)], scoring["support_v3"]),
            "cuda6 support != cuda (K2) on the real intervals")
    require(not sup6[len(real):].any(), "a decoy interval has support")
    t0 = time.perf_counter()
    build_l, score_l = make_batch_scorer(ic, lin_s, lin_e, "torch",
                                         device="cuda")
    sup_t, cov_t = score_l(build_l(scoring["starts"], scoring["ends"]),
                           *_unpacked_columns(table, pi, span))
    sup_t, cov_t = sup_t.cpu().numpy(), cov_t.cpu().numpy()
    t_torch = time.perf_counter() - t0
    require(np.array_equal(sup6, sup_t), "cuda6 support != torch engine")
    cov_np = _coverage_numpy(scoring["starts"], scoring["ends"], lin_s,
                             lin_e)
    require(np.array_equal(cov_t, cov_np),
            "long list: torch coverage != numpy")
    require(np.array_equal(cov6, cov_np),
            "long list: cuda6 coverage != numpy")

    # -- K3, K4 against their plain versions at this path's own shape, with
    #    their times (after the counts were read)
    rep = {}
    hit_k = check_6col(kernels, "WGS sample, decoys last",
                       (ic, is_.astype(np.int32), ie.astype(np.int32)),
                       packed6, rep, plain_reps=2, tag="4b wgs6")
    require(np.array_equal(hit_k, hit_c), "K3 at the path's shape != path")
    for name, r in rep.items():
        report[name].append(r)
    fc, fs, fe = _interval_arrays(decoys + real)
    rep_f = {}
    check_6col(kernels, "WGS sample, decoys first",
               (fc, fs.astype(np.int32), fe.astype(np.int32)), packed6,
               rep_f, plain_reps=2, tag="4b wgs6")
    for name, r in rep_f.items():
        # its times stay in the log; its error joins the result line's
        report[name][-1]["max_abs_err"] = max(
            report[name][-1]["max_abs_err"], r["max_abs_err"])
    log(f"[4b wgs6] {len(last)} intervals ({len(real)} real + "
        f"{len(decoys)} decoys), {len(pi)} pairs: hit mask and BpTable "
        f"({len(tb_c)} rows) cuda==numpy, ==K1 on the real intervals, "
        f"unchanged with the decoys first")
    log(f"[4b wgs6] find_breakpoints_device s: cuda {t_c:.3f} (pair scoring "
        f"{routes[0].seconds:.3f}) decoys-first cuda {t_f:.3f} numpy "
        f"{t_n:.3f}")
    log(f"[4b wgs6] batch scorer cuda6 (K4) {t_score6:.3f} s == cuda (K2) on "
        f"the real intervals == torch on the long list ({t_torch:.3f} s); "
        f"support {sup6[:len(real)].tolist()}, decoys 0, coverage exact")
    log(f"[4b wgs6] launches in this path's run: {launches}")
    return launches


def phase_v2_path(rec, scoring, report):
    """4c: the v2 route.  The WGS sample's pairs through the native
    ``pack_pairs2``, then ``make_batch_scorer(engine="cuda2")`` (K6) and
    ``pair_predicates_packed2`` (K5).  Returns the launch counts of that
    run."""
    from coral_tpu_torch.native.bamcore import pack_pairs2
    from coral_tpu_torch.ops import kernels
    from coral_tpu_torch.ops.scoring import make_batch_scorer

    table, pi, span = scoring["table"], scoring["pi"], scoring["span"]
    ic, is_, ie = _interval_arrays(rec.amplicon_intervals)
    _, lin_s, lin_e = _interval_arrays(rec.amplicon_intervals, span)
    reads = scoring["starts"], scoring["ends"]

    # this path's run: counters from zero
    kernels.reset_launches()
    t0 = time.perf_counter()
    packed2 = pack_pairs2(pi, table.q_start, table.q_end, table.r1, table.r2,
                          table.chrom, table.strand, table.mapq, ic, is_, ie)
    t_pack = time.perf_counter() - t0
    t0 = time.perf_counter()
    build2, score2 = make_batch_scorer(ic, lin_s, lin_e, "cuda2",
                                       device="cuda")
    sup2, cov2 = score2(build2(*reads), *packed2)
    sup2, cov2 = sup2.cpu().numpy(), cov2.cpu().numpy()
    t_score = time.perf_counter() - t0
    t0 = time.perf_counter()
    hit2, iog2 = kernels.pair_predicates_packed2(
        packed2, len(pi), CUTOFF, MIN_MAPQ, GAP, device="cuda")
    t_mask = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    require(launches["pair2"] >= 1, f"K5 never launched: {launches}")
    require(launches["pair2_support"] >= 1, f"K6 never launched: {launches}")

    require(np.array_equal(hit2, scoring["hit_v3"]),
            "v2 route: K5 hit mask != K1's of the main path")
    require(np.array_equal(sup2, scoring["support_v3"]),
            "cuda2 support != cuda (K2)")
    require(np.array_equal(cov2, scoring["cov_v3"]),
            "cuda2 coverage != cuda")
    build_t, score_t = make_batch_scorer(ic, lin_s, lin_e, "torch",
                                         device="cuda")
    sup_t, cov_t = score_t(build_t(*reads),
                           *_unpacked_columns(table, pi, span))
    require(np.array_equal(sup2, sup_t.cpu().numpy()),
            "cuda2 support != torch engine")
    require(np.array_equal(cov2, cov_t.cpu().numpy()),
            "cuda2 coverage != torch engine")
    require(np.array_equal(np.bincount(iog2[hit2], minlength=len(ic)), sup2),
            "K5's hits binned by iog != K6's support")
    # K5, K6 against their plain versions at this path's own shape, with
    # their times (after the counts were read)
    hit_k = check_v2(kernels, "WGS sample", packed2, len(ic), report,
                     tag="4c wgs2")
    require(np.array_equal(hit_k, hit2), "K5 at the path's shape != path")
    log(f"[4c wgs2] {len(pi)} pairs, {len(ic)} intervals: native pack_pairs2 "
        f"{t_pack:.3f} s; batch scorer cuda2 (K6 + int64 coverage) "
        f"{t_score:.3f} s == cuda (K2) == torch, support {sup2.tolist()}, "
        f"coverage exact; hit mask (copies + K5) {t_mask:.3f} s == K1's of "
        f"4a ({int(hit2.sum())} hits)")
    log(f"[4c wgs2] launches in this path's run: {launches}")
    return launches


def phase_coverage_path(rec, report):
    """4d: genome-bin coverage.  The WGS sample's read spans, chromosome by
    chromosome, through ``bin_coverage(engine="cuda")`` (K8).  Returns the
    launch counts of that run."""
    from coral_tpu_torch.ops import kernels
    from coral_tpu_torch.ops.coverage import CoverageIndex, bin_coverage

    bam = rec.bam
    n_bins = -(-WGS_CHR_LEN // COVERAGE_BIN)
    spans = []
    for rid in range(len(bam.references)):
        rows = bam.ref_id == rid
        spans.append((bam.pos[rows].astype(np.int32),
                      bam.end[rows].astype(np.int32)))

    # this path's run: counters from zero
    kernels.reset_launches()
    t0 = time.perf_counter()
    hists = [bin_coverage(s, e, 0, COVERAGE_BIN, n_bins, engine="cuda",
                          device="cuda") for s, e in spans]
    t_bins = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    require(launches["bin_overlap"] == len(spans),
            f"K8 launches != chromosomes: {launches}")

    t0 = time.perf_counter()
    for (s, e), hist in zip(spans, hists):
        index = CoverageIndex(s, e, device="cuda")
        require(np.array_equal(hist, index.bin_histogram(0, COVERAGE_BIN,
                                                         n_bins)),
                "bin_coverage != CoverageIndex.bin_histogram")
    t_index = time.perf_counter() - t0
    s, e = (a.astype(np.int64) for a in spans[0])
    edges = COVERAGE_BIN * np.arange(n_bins + 1, dtype=np.int64)
    require(np.array_equal(hists[0],
                           _coverage_numpy(s, e, edges[:-1], edges[1:])),
            "bin_coverage != numpy on the first chromosome")
    require(int(hists[0].sum()) == int(np.minimum(e, edges[-1]).sum()
                                       - s.sum()),
            "bins do not add up to the aligned bases")
    n_reads = sum(len(s) for s, _ in spans)
    require(n_reads == int((bam.ref_id >= 0).sum()), "reads left out")
    # K8 on the same reads in 1 kb bins, six tiles of shared memory (a
    # caller's finer binning), then at this path's own shape, with its
    # times (the result line carries the last)
    check_bins(kernels, "WGS sample, one chromosome, 1 kb bins", *spans[0],
               0, 1_000, -(-WGS_CHR_LEN // 1_000), report, tag="4d bins")
    hist = check_bins(kernels, "WGS sample, one chromosome", *spans[0], 0,
                      COVERAGE_BIN, n_bins, report, tag="4d bins")
    require(np.array_equal(hist, hists[0]), "K8 at the path's shape != path")
    log(f"[4d bins] {n_reads} reads on {len(spans)} chromosomes, {n_bins} "
        f"bins of {COVERAGE_BIN} each: bin_coverage(cuda) {t_bins:.3f} s "
        f"(copies included) == CoverageIndex.bin_histogram ({t_index:.3f} s, "
        f"tables built per chromosome) == numpy on {bam.references[0][0]}; "
        f"{int(sum(h.sum() for h in hists))} aligned bases")
    log(f"[4d bins] launches in this path's run: {launches}")
    return launches


def phase_cluster_path(work: str, report):
    """4e: clustering.  ``cluster_breakpoints(engine="cuda")`` (K9) against
    ``engine="host"`` on the mixed sample's breakpoint rows and on a seeded
    list with large groups.  Returns the launch counts of that run."""
    from coral_tpu_torch.config import DEFAULT_CONFIG
    from coral_tpu_torch.io.bam import BamFile
    from coral_tpu_torch.ops import breakpoints as bp_mod
    from coral_tpu_torch.ops import kernels
    from coral_tpu_torch.ops.pairs import find_breakpoints_device
    from coral_tpu_torch.reconstruct import Reconstruction
    from coral_tpu_torch.sim import simulate_mixed_sample

    bam, cns, seeds = simulate_mixed_sample(work, seed=3)
    rec = Reconstruction(BamFile(bam), seeds, DEFAULT_CONFIG, device="cuda")
    rec.read_cns(cns)
    rec.collect()
    rec.hash_to_segments()
    rec.find_amplicon_intervals()
    cfg_b = rec.cfg.bp
    rows = find_breakpoints_device(
        rec.chimeras, rec.amplicon_intervals, cfg_b.min_bp_match_cutoff,
        cfg_b.min_mapq, 100, cfg_b.gap_mapq, None, engine="cuda",
        device="cuda")
    rec.bam.close()
    sizes = (1000, 1500, 2500, 4096, 5000, 300, 40)
    synth = synth_breakpoints(seed=11, group_sizes=sizes)
    lists = (("mixed sample", rows, rec.min_cluster_cutoff,
              cfg_b.max_bp_distance_cutoff),
             ("seeded list", synth, 3, MATCH_CUTOFF))

    def ids(clusters):
        return [[id(m) for m in c] for c in clusters]

    # this path's run: counters from zero
    kernels.reset_launches()
    out = []
    for name, bps, min_size, cutoff in lists:
        t0 = time.perf_counter()
        dev = bp_mod.cluster_breakpoints(bps, min_size, cutoff,
                                         engine="cuda", device="cuda")
        out.append((dev, time.perf_counter() - t0))
    launches = dict(kernels.LAUNCHES)
    require(launches["match_matrix"] >= 6,
            f"K9 launches (one a group under the cap): {launches}")

    for (name, bps, min_size, cutoff), (dev, t_dev) in zip(lists, out):
        t0 = time.perf_counter()
        host = bp_mod.cluster_breakpoints(bps, min_size, cutoff)
        t_host = time.perf_counter() - t0
        require(ids(dev) == ids(host), f"{name}: cuda clusters != host")
        require(sum(map(len, dev)) == len(bps), f"{name}: members lost")
        groups = {}
        for bp in bps:
            key = (bp[0], bp[3], bp[2], bp[5])
            groups[key] = groups.get(key, 0) + 1
        log(f"[4e cluster] {name}: {len(bps)} rows in {len(groups)} groups "
            f"(largest {max(groups.values())}), {len(dev)} clusters, "
            f"cuda == host member for member; s cuda {t_dev:.3f} host "
            f"{t_host:.3f}")
    require(max(sizes) > bp_mod._DEVICE_GROUP_CAP, "no group past the cap")
    # K9 against its plain version at this path's largest shape
    big = [bp for bp in synth if bp[6][1] == sizes.index(4096)]
    check_match(kernels, "seeded list, largest group under the cap",
                np.asarray([bp[1] for bp in big], np.int32),
                np.asarray([bp[4] for bp in big], np.int32), MATCH_CUTOFF,
                report, tag="4e cluster")
    log(f"[4e cluster] launches in this path's run: {launches}")
    return launches


# -- phase 5 --------------------------------------------------------------

def phase_cycles(work: str) -> None:
    from coral_tpu_torch.sim import simulate_mixed_sample

    bam, cns, seeds = simulate_mixed_sample(work, seed=3)
    secs = {}
    for engine in ("cuda", "numpy"):
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, "-m", "coral_tpu_torch", "reconstruct",
             "--lr_bam", bam, "--cnv_seed", seeds, "--cn_seg", cns,
             "--output_prefix", os.path.join(work, engine),
             "--engine", engine, "--device", "cuda",
             "--log_fn", os.path.join(work, f"{engine}.log")],
            cwd=ROOT, check=True, stdout=subprocess.DEVNULL, timeout=600)
        secs[engine] = time.perf_counter() - t0
    outs = sorted(f for f in os.listdir(work) if f.startswith("cuda_")
                  and f.endswith(("_graph.txt", "_cycles.txt")))
    require(sum(f.endswith("_cycles.txt") for f in outs) > 0,
            "no cycles files")
    for f in outs:
        require(filecmp.cmp(os.path.join(work, f),
                            os.path.join(work, "numpy" + f[4:]),
                            shallow=False), f"{f}: cuda != numpy")
    with open(os.path.join(work, "cuda.log")) as fh:
        route = [ln.strip() for ln in fh if "pair scoring route" in ln]
    require(any("engine=cuda" in ln for ln in route),
            f"CLI run did not score with cuda: {route}")
    log(f"[5 cycles] mixed sample: {len(outs)} graph+cycles files identical "
        f"cuda==numpy; CLI s cuda {secs['cuda']:.2f} numpy "
        f"{secs['numpy']:.2f}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "coral_tpu_torch")):
        print("run from a checkout of the repository", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    smi = phase_env()
    phase_build()
    report = phase_kernels()
    with tempfile.TemporaryDirectory() as work:
        rec, launches, wgs_errs, scoring = phase_main_path(work)
        launches6 = phase_six_column_path(rec, scoring, report)
        launches2 = phase_v2_path(rec, scoring, report)
        launches_bins = phase_coverage_path(rec, report)
        rec.bam.close()
    with tempfile.TemporaryDirectory() as work:
        launches_match = phase_cluster_path(work, report)
    with tempfile.TemporaryDirectory() as work:
        phase_cycles(work)
    banned = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "coral_tpu")]
    require(not banned, f"imported: {banned}")
    # a kernel's launches are those of its own path's run; the copy
    # control's are those of the reconstruct run, whose columns it read
    counted = {"pair3": launches, "pair3_support": launches,
               "pair6": launches6, "pair6_support": launches6,
               "stream_control": launches, "pair2": launches2,
               "pair2_support": launches2, "bin_overlap": launches_bins,
               "match_matrix": launches_match}
    kern = []
    for name, (source, replaces) in KERNELS.items():
        rows = report[name]
        last = rows[-1]
        err = max([r["max_abs_err"] for r in rows] + [wgs_errs.get(name, 0)])
        kern.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": counted[name][name],
                     "max_abs_err": err, "ms": last["ms"],
                     "plain_ms": last["plain_ms"],
                     "bound_ms": last["bound_ms"],
                     "bound_by": last["bound_by"], "library_ms": None,
                     "case": last["case"]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(f"gpu: {smi}")
    log(json.dumps({"kernels": kern}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
