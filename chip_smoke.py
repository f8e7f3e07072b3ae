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
   layout at 2^21 pairs with 16 and with 8,200 intervals and either side
   of their switch from a scan of the table to lookups in its interval
   index (and K4 ÷ K3), once with every hit on 14 intervals whose slots in
   K4's bin cache collide, the index's build against its plain version
   wherever they look sides up, K8 at 2^21 reads over 256 and over 65,536
   bins, at
   n_bins either side of each switch of its plan on this card, and over
   the reads sorted by start (also against the prefix-sum histogram), the
   floor of one timed call, K9 at 2,048, 1,001 and 4,096 positions; K1's
   device time by the profiler, after an L2 flush and warm;
4. the main paths at WGS scale, on the junction-heavy 10-chromosome
   sample (5,179,920 records, 1.5 M pairs):
   a. reconstruct through ``bench_wgs.run_staged`` with the ``cuda``
      engine (K1) and the fused batch scorer (K2) against the ``numpy``
      engine: graph files byte-identical, support and coverage exact;
   b. the 6-column route: the sample's amplicon intervals plus 8,190
      decoy intervals that overlap no read, so the ``cuda`` engine goes
      through K3 and the ``cuda6`` batch scorer through K4, both on the
      list's interval index; hit mask and BpTable over every read
      against the ``torch`` engine on the card, against K1 on the real
      intervals alone, again with the decoys placed first, and against
      the ``numpy`` engine over every tenth read's chimeras; the stage's
      time three times each way;
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
   f. the batched CN engine: the sample's 10 graphs as 4a built them,
      ``compute_cn(engine="batch")`` on the card against ``numpy``
      (graph files byte-identical), 256 seeded chain systems of up to
      477 rows solved together against the numpy engine one by one
      (every ``"%f" % (2x)`` digit equal), and the batch's time against
      the numpy loop's at 1 to 256 systems;
   g. the fused scoring step: ``make_fused_step`` with its ``cuda``
      engine (K4) against ``torch`` and the numpy twin on the sample's
      unpacked pairs, over its 10 intervals and with 8,190 decoys first:
      support bit-equal, coverage equal in int64;
5. the full pipeline with cycles on a mixed sample through
   ``python -m coral_tpu_torch reconstruct``, ``cuda`` vs ``numpy``:
   graph and cycles files byte-identical;
6. the user's pipeline on the same sample through the CLI: ``seed`` on its
   ``.cns``, ``reconstruct`` from the bed it wrote with the ``cuda`` and
   ``batch`` engines and again with ``numpy`` for both (graph and cycles
   files byte-identical), and ``cycle2bed`` on the cycles with and without
   ``--rotate_to_min``.  ``hsr`` and ``plot`` need matplotlib, which the
   machine with the card may not have; they run no device code, and the
   CPU tests hold them to the JAX package's;
7. the mesh and multi-process layer (``coral_tpu_torch.parallel``) on the
   WGS sample, every result against the single-device one:
   ``score_pairs_sharded`` over 1, 2 and 4 shards of the card with the
   ``cuda`` engine (K1 per shard over the sample's 10 intervals, K3 per
   shard over 8,200 with the decoys first, the index built once a call)
   and over 4 with ``torch``, hit masks bit-equal; ``reconstruct_graphs``
   on a mesh of the card, graph files byte-identical; K8 per shard
   through ``bin_coverage_sharded`` over 4 read shards and a 2 x 2 mesh
   that splits the bins, equal in int64; the batch CN engine over 4
   shards, every digit; the BAM split into 2 and 4 shards, each scanned
   by its own process, through ``multihost_reconstruct_graphs`` once a
   shard count (graph files byte-identical; its scan and merge timed
   against 4a's scan+collect); a 2-process gloo group on the card
   through the pipeline worker on the mixed sample (each rank's graph and
   cycles files byte-identical to the single-process run); a 1-process
   nccl group (``allreduce_sum``, ``allgather_bytes``,
   ``shard_bin_histogram`` with K8), and two nccl ranks on the one card,
   which must both raise.  Launches of K1, K3, the index and K8 in these
   paths are counted and added to theirs;
8. the last modules of the slice, on the WGS sample:
   a. ``make_pipelined_scorer(engine="cuda")`` over its pairs, packed by
      the native ``pack_pairs3`` and padded to 6 x 2^18: K2 exactly once a
      chunk (added to K2's launches), support and int64 coverage equal to
      4a's and to the ``torch`` engine on the card; host seconds of 3 runs
      against the monolithic ``make_batch_scorer(engine="cuda")`` with its
      pageable copies, and of the copies alone (pageable, pinned, through
      one pinned staging buffer);
   b. ``auto`` routing, three arms of the breakpoints stage: ``numpy``
      forced; ``auto`` in a fresh process whose build directory holds no
      kernels' library (must route ``numpy`` for ``cold``, build and load
      nothing, and leave ``torch.cuda.is_initialized()`` False), which
      then times the load (``dlopen``, first context, first call) and
      runs ``Reconstruction`` with ``EngineConfig(device_pair_threshold=
      10**12)`` (must route ``numpy`` for the threshold); ``auto`` here
      with the library loaded and one observation (must route ``cuda``).
      BpTables identical, each ``auto`` arm's scoring within 2 s of the
      numpy arm's (``auto_never_loses``), the calibration printed;
   c. ``compute_cn_hybrid`` on the sample's 10 graphs with seeded
      short-read counts, every ``"%f"`` digit of the program solved by the
      numpy engine;
9. the port's tools (``coral_tpu_torch/tools``), each through its own
   entry, its JSON printed and every check required: ``bench_kernels``
   at its three shapes (K3, K8, K9; every row agrees), ``bench_v3_ab``
   at 2^21 pairs (K6, K2, K1; support identical, hits K1's and numpy's),
   ``bench_e2e`` at its default size with ``--engine cuda`` against
   ``--engine numpy --cn_engine numpy`` (graph and cycles files
   identical) and ``stress_scan`` at 4 chromosomes of 1.5 kb reads
   (every record built scanned).  Phase 4a runs
   ``bench_wgs.build_junction_heavy`` and ``bench_wgs.run_staged``, and
   phase 7's fan-out runs through ``bench_multihost.scaling``.  The
   tools' launches, counted from zero a tool, are added to the
   kernels'.

The last three lines are the card (``nvidia-smi``), a JSON object with
one entry per kernel, and ``{"ok": true, "device": {...}}``.  Nothing here
imports JAX or the JAX package.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.

A kernel's ``bound_ms`` is the least time the card could take for the same
work: the larger of the bytes it must move (inputs read once, outputs
written once) over 3.35 TB/s and its integer operations over 16.75 T/s
(H100 SXM: 64 int32 lanes on each of 132 SMs, a quarter of the 67 TFLOP/s
float32 rate, which counts 128 lanes and two operations per FMA).  The
operations of K3 and K4 are counted from this run's data: thirty a pair
for the decision and four a step for each lookup the data needs, a lookup
being two binary searches and a walk down the index, ``3 log2 n_int + 1``
steps (the log adds the linear scan's count beside it, ten per interval
the scan examines); those of the index's build from its size; those of K8 from the
reads: twelve a read and ten per bin that it touches.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import filecmp
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# the port's tools, and the inputs and timer they share (the tests import
# the inputs from here too)
from coral_tpu_torch.tools import bench_e2e, bench_kernels, bench_multihost, \
    bench_v3_ab, bench_wgs, stress_scan
from coral_tpu_torch.tools.bench_common import cuda_ms, engine_config, \
    synth_alignment_table, synth_scoring_batch
from coral_tpu_torch.tools.bench_wgs import CHR_LEN as WGS_CHR_LEN, \
    CHROMS as WGS_CHROMS, build_junction_heavy

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
OPS_PER_LOOKUP_STEP = 4   # load, compare, select, halve (a search or a level)
OPS_PER_BUILD_STEP = 4    # the build's binary search, a step
OPS_PER_BUILD_SLOT = 12   # a slot of a level: place, cl, two minima, stores
OPS_PER_PAIR_V2 = 30      # meta2 decode, MAPQ gate, reference jump, decision
OPS_PER_READ = 12         # clip to the binned range, first bin (csrc/bins.cu)
OPS_PER_TOUCHED_BIN = 10  # edge, min, difference, atomic, step
OPS_PER_READ_RECOUNTED = 30  # clip, two bins, two partials, merge, counts
OPS_PER_CELL = 9          # two x (min, max, subtract, compare) + and
N_READS = 1 << 21
READ_SPAN = 200_000_000
MATCH_CUTOFF = 2000
COVERAGE_BIN = 100_000    # phase 4d: 1,594 bins a chromosome
CN_SYSTEMS = 256          # phase 4f: chains of 3 to 120 segments
CN_BATCHES = (1, 8, 32, 128, 256)
FUSED_SAMPLE = 64         # phase 4g: the numpy twin on every 64th pair of
#                           the long list (its masks are pairs x intervals)

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
    # the build of the index that K3 and K4 look sides up in: with their
    # lookups it replaces the TPU kernel's interval scan
    "interval_index": ("coral_tpu_torch/csrc/index.cu",
                       "coral_tpu/ops/pallas_kernels.py:36"),
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


def device_us(fn, kernel: str, flush: bool, reps: int = 20):
    """Device µs a call of the kernel whose name holds ``kernel``, in
    ``reps`` calls of ``fn``, as the profiler reads it
    (``coral_tpu_torch/tools/kernel_ab.py``), each call after an L2 flush
    with ``flush``; None where the profiler sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    buf = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush:
                    buf.zero_()
                fn()
            torch.cuda.synchronize()
        rows = prof.key_averages()
    except RuntimeError as exc:   # no device trace on this machine
        log(f"profiler: {exc}")
        return None
    total = sum(getattr(r, "device_time_total", None)
                or getattr(r, "cuda_time_total", 0)
                for r in rows if kernel in r.key)
    return total / reps or None


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


def bound_6col_scan(io: np.ndarray, n_int: int, out_bytes: int):
    """K3/K4's bound counted for a linear scan of the table, the design
    before the interval index: ten operations for every interval a pair
    examines before its side i is found (-1 in ``io``: the whole table).
    Kept for comparison with :func:`bound_6col`."""
    n = len(io)
    examined = int(np.where(io >= 0, io.astype(np.int64) + 1, n_int).sum())
    return bound_ms(24 * n + 12 * n_int + out_bytes,
                    OPS_PER_INTERVAL * examined + OPS_PER_PAIR_6COL * n)


def lookups_6col(ints, packed, io, support: bool) -> int:
    """The first-overlap lookups that K3 (``support`` False) or K4 needs on
    these columns, ``io`` their side i's first intervals: side i for every
    pair (K4: for the pairs whose MAPQs and junction test pass, the only
    ones it counts), side j where those pass, side i was found and its
    interval overlaps side j."""
    ic, is_, ie = (np.asarray(a, np.int64) for a in ints)
    qgap, r1_i, r2_i, r1_j, r2_j, meta = (np.asarray(c, np.int64)
                                          for c in packed)
    side_i, side_j = meta >> 14, meta & 0x3FFF
    plus_j = (side_j & 1) == 1
    grr = np.where(plus_j, r1_j - r2_i, r2_i - r1_j)
    could = (((side_i >> 1) & 0xFF) >= MIN_MAPQ) \
        & (((side_j >> 1) & 0xFF) >= MIN_MAPQ) & (qgap + CUTOFF >= 0) \
        & (((side_i & 1) != (side_j & 1))
           | (np.abs(qgap - grr) > np.maximum(GAP, 0.2 * np.abs(qgap))))
    k = np.where(io >= 0, io, 0)
    side_j_too = could & (io >= 0) & (ic[k] == (side_j >> 9) - 1) \
        & (r1_j <= ie[k]) & (is_[k] <= r2_j)
    first = int(could.sum()) if support else len(io)
    return first + int(side_j_too.sum())


def bound_6col(ints, packed, io, out_bytes: int, support: bool):
    """Bound of K3/K4 as a function, recounted for the interval index:
    the 24 B a pair read, the table and the output, and per pair the
    decision and the lookups these columns need (:func:`lookups_6col`),
    each two binary searches and a walk down the levels, ``3 log2 n_int
    + 1`` steps.  The index's build is bound apart
    (:func:`bound_index`)."""
    n, n_int = len(io), len(ints[0])
    steps = 3 * max(n_int - 1, 1).bit_length() + 1
    return bound_ms(24 * n + 12 * n_int + out_bytes,
                    OPS_PER_PAIR_6COL * n + OPS_PER_LOOKUP_STEP * steps
                    * lookups_6col(ints, packed, io, support))


def bound_index(n_int: int):
    """Bound of the index's build: the table read once, the keys and
    levels written once; a sort of the start keys and, for each level l,
    a slot's placement by a binary search of l - 1 steps."""
    top = max(n_int - 1, 0).bit_length()
    ops = OPS_PER_BUILD_STEP * n_int * top + sum(
        n_int * (OPS_PER_BUILD_SLOT + OPS_PER_BUILD_STEP * max(level - 1, 0))
        for level in range(top + 1))
    return bound_ms(12 * n_int + 16 * n_int + 8 * (top + 1) * n_int, ops)


# -- inputs ---------------------------------------------------------------

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
    # K1's device time, which holds no call's floor, against its bound,
    # cold (after an L2 flush, as the bound reads its inputs) and warm
    k1 = fns["pair3"][0]
    cold = device_us(k1, "pair3_hitmask", flush=True)
    warm = device_us(k1, "pair3_hitmask", flush=False)
    bound_us = report["pair3"]["bound_ms"] * 1e3
    log(f"[3 kernels] v3 {case}: K1 device us (profiler) after an L2 flush "
        f"{cold if cold is None else round(cold, 2)}, warm "
        f"{warm if warm is None else round(warm, 2)}; bound {bound_us:.2f} "
        f"us, bound / cold device time "
        f"{'not measured' if cold is None else f'{bound_us / cold:.3f}'}")


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
    """K3 and K4 against their plain versions on one 6-column case and,
    where they look sides up in the interval index, the index's build
    against its plain version; fills ``report`` and returns the kernel's
    hit mask (numpy).  K3's and K4's times include the index's build."""
    import torch

    from coral_tpu_torch.ops.interval_index import build_interval_index, \
        build_interval_index_torch
    from coral_tpu_torch.ops.scoring import state_from_numpy

    st = state_from_numpy(*ints, packed, device="cuda")
    table = (st.int_chrom, st.int_start, st.int_end)
    args = (*table, *st.packed)
    kw = dict(cutoff=CUTOFF, min_mapq=MIN_MAPQ, gap_=GAP)
    n, n_int = len(packed[0]), len(ints[0])
    indexed = n_int > kernels.PAIR6_SCAN_MAX_INTERVALS

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
                  bound_6col(ints, packed, io, 5 * n, support=False)),
        "pair6_support": (lambda: kernels.pair6_support(*args, **kw),
                          lambda: kernels.pair6_support_torch(*args, **kw),
                          bound_6col(ints, packed, io, 4 * n_int,
                                     support=True)),
    }
    if indexed:
        ix = build_interval_index(*table, "cuda")
        ref = build_interval_index_torch(*table)
        torch.cuda.synchronize()
        errs["interval_index"] = max(
            int((a.long() - b.long()).abs().max()) if a.numel() else 0
            for a, b in ((ix.skey, ref.skey), (ix.ekey, ref.ekey),
                         (ix.lev, ref.lev)))
        require(ix.top == ref.top and errs["interval_index"] == 0,
                f"index build != plain ({case})")
        fns["interval_index"] = (
            lambda: build_interval_index(*table, "cuda"),
            lambda: build_interval_index_torch(*table), bound_index(n_int))
    for name, (kern, plain, bound) in fns.items():
        report[name] = _row(f"{case}, {n} pairs, {n_int} intervals",
                            errs[name], kern, plain, bound, plain_reps)
    sup = sup_k.cpu().numpy()
    route = "index" if indexed else "scan"
    _log_rows(tag, f"6-column {case}: n={n} n_int={n_int} route={route} "
              f"hits={int(hit_k.sum())} found_i={int((io >= 0).sum())} "
              f"bins hit={int((sup > 0).sum())} K3==plain K4==plain"
              + (" build==plain" if indexed else ""), report)
    scan3, scan4 = (bound_6col_scan(io, n_int, out)[0]
                    for out in (5 * n, 4 * n_int))
    log(f"[{tag}] 6-column {case}: K4/K3 "
        f"{report['pair6_support']['ms'] / report['pair6']['ms']:.3f}; "
        f"lookups K3 {lookups_6col(ints, packed, io, False)} K4 "
        f"{lookups_6col(ints, packed, io, True)}; bound as a scan "
        f"K3 {scan3:.4f} K4 {scan4:.4f} ms")
    if indexed:
        given = (cuda_ms(lambda: kernels.pair6_hitmask(*args, **kw,
                                                        index=ix)),
                 cuda_ms(lambda: kernels.pair6_support(*args, **kw,
                                                       index=ix)))
        log(f"[{tag}] 6-column {case}: index build (cold) "
            f"{report['interval_index']['ms']:.4f} ms; on a built index "
            f"K3 {given[0]:.4f} K4 {given[1]:.4f} ms")
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
    # K3 and K4 either side of their switch from the scan to the index
    for n_int in (kernels.PAIR6_SCAN_MAX_INTERVALS,
                  kernels.PAIR6_SCAN_MAX_INTERVALS + 1):
        rep = {}
        check_6col(kernels, "dense, at the switch",
                   *dense_case6(N_PAIRS, n_int, seed=n_int), rep,
                   plain_reps=2)
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

    from coral_tpu_torch.ops import kernels
    from coral_tpu_torch.ops.pairs import adjacent_pair_indices, \
        build_chimera_table, last_route_seq, route_records_since
    from coral_tpu_torch.ops.scoring import make_batch_scorer, \
        pack_pairs3_host, pair_predicate_packed3_np, state_from_numpy

    t0 = time.perf_counter()
    bam, cns, seeds, n_rec = build_junction_heavy(work)
    log(f"[4 wgs] junction-heavy sample: {n_rec} records built in "
        f"{time.perf_counter() - t0:.1f} s")

    cfg = engine_config
    kept = {}

    def keep(rec):
        # the Reconstruction, and its graphs as CN finds them (phase 4f);
        # run_staged leaves this out of its stages
        kept["rec"], kept["before_cn"] = rec, copy.deepcopy(rec.graphs)

    # the main path's run, through the tool: counters from zero, nothing
    # else launches
    seq = last_route_seq()
    kernels.reset_launches()
    st_c, route_lines, files, n_amp, _ = bench_wgs.run_staged(
        bam, cns, seeds, os.path.join(work, "cuda"), engine="cuda",
        skip_cycles=True, device="cuda", on_graphs=keep)
    rec_c, before_cn = kept["rec"], kept["before_cn"]
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

    st_n, _, files_n, _, _ = bench_wgs.run_staged(
        bam, cns, seeds, os.path.join(work, "numpy"), engine="numpy",
        skip_cycles=True, device="cuda")
    n_pairs = routes[0].n_pairs if routes else 0
    require(routes and routes[0].engine == "cuda",
            f"main path did not route to cuda: {routes}")
    require(launches["pair3"] > 0, f"K1 never launched: {launches}")
    require(launches["pair3_support"] > 0, f"K2 never launched: {launches}")
    require(n_amp == len(rec_c.graphs) == len(files) == len(files_n) > 0,
            f"graph files: {sorted(files)}, {sorted(files_n)}")
    for f, text in files.items():
        require(text == files_n.get("numpy" + f[4:]), f"{f}: cuda != numpy")
    hit, iogm = pair_predicate_packed3_np(*packed, CUTOFF, GAP)
    require(np.array_equal(
        support, np.bincount(iogm[hit], minlength=len(ic))[:len(ic)]),
        "WGS support != numpy")
    require(np.array_equal(cov, _coverage_numpy(starts, ends, lin_s, lin_e)),
            "WGS coverage != numpy")
    log(f"[4a wgs] records {n_rec} chimeric pairs {n_pairs} amplicons "
        f"{len(rec_c.graphs)} graph files identical cuda==numpy")
    log(f"[4a wgs] bench_wgs.run_staged stages s, engine cuda: "
        f"{json.dumps(st_c)}; pair scoring {routes[0].seconds:.3f} s; "
        f"{route_lines}")
    log(f"[4a wgs] bench_wgs.run_staged stages s, engine numpy: "
        f"{json.dumps(st_n)}")
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
                   hit_v3=hit_k.cpu().numpy(), support_v3=support, cov_v3=cov,
                   before_cn=before_cn, stages=st_c, stages_numpy=st_n,
                   inputs=(bam, cns, seeds), cfg=cfg("cuda"))
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


NUMPY_READ_STRIDE = 10    # 4b: the numpy witness scores a tenth of the reads


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

    def extract(intervals, engine, chimeras=rec.chimeras):
        masks = []
        t0 = time.perf_counter()
        with recorded_hit_masks(pairs_mod, masks):
            tb = pairs_mod.find_breakpoints_device(
                chimeras, intervals, cfg_b.min_bp_match_cutoff,
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
    require(launches["interval_index"] >= 1,
            f"the interval index was never built: {launches}")
    require(launches["pair3"] == 0, f"K1 ran on the long list: {launches}")
    # the breakpoints stage again, for its spread (after the counts)
    t_cs = [t_c] + [extract(last, "cuda")[2] for _ in range(2)]

    # -- against the torch engine (the plain predicate, on the card) over
    #    every read: hit mask and BpTable
    tb_t, hit_t, t_t = extract(last, "torch")
    require(np.array_equal(hit_c, hit_t), "long list: cuda hit mask != torch")
    require(_bp_tables_equal(tb_c, tb_t), "long list: cuda BpTable != torch")
    # -- against the numpy engine, a host witness, over the chimeras of
    #    every NUMPY_READ_STRIDE-th read: its scan of 8,200 intervals an
    #    alignment takes 60-85 s over all of them
    sub = {rn: rec.chimeras[rn]
           for rn in rec.chimeras.names[::NUMPY_READ_STRIDE]}
    tb_s, hit_s, _ = extract(last, "cuda", sub)
    tb_n, hit_n, t_n = extract(last, "numpy", sub)
    require(hit_n.any(), "long list: no hit in the numpy engine's reads")
    require(np.array_equal(hit_s, hit_n), "long list: cuda hit mask != numpy")
    require(_bp_tables_equal(tb_s, tb_n), "long list: cuda BpTable != numpy")
    # -- against the v3 route (K1) on the real intervals alone
    require(np.array_equal(hit_c, scoring["hit_v3"]),
            "long list: K3 hit mask != K1 on the real intervals")
    # -- decoys first: indices shift, hits do not
    tb_f, hit_f, t_f = extract(decoys + real, "cuda")
    require(np.array_equal(hit_f, hit_c), "decoys first: hit mask moved")
    require(_bp_tables_equal(tb_f, tb_c), "decoys first: BpTable moved")
    t_fs = [t_f] + [extract(decoys + real, "cuda")[2] for _ in range(2)]
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
        # the result line carries this case, the linear scan's worst,
        # with the errors of both
        report[name].append(dict(r, max_abs_err=max(
            report[name][-1]["max_abs_err"], r["max_abs_err"])))
    log(f"[4b wgs6] {len(last)} intervals ({len(real)} real + "
        f"{len(decoys)} decoys), {len(pi)} pairs: hit mask and BpTable "
        f"({len(tb_c)} rows) cuda==torch over every read, ==K1 on the real "
        f"intervals, unchanged with the decoys first; cuda==numpy over every "
        f"{NUMPY_READ_STRIDE}th read's chimeras ({len(sub)} reads, "
        f"{len(hit_n)} pairs, {len(tb_n)} rows)")
    log(f"[4b wgs6] find_breakpoints_device s (the breakpoints stage of "
        f"the long list), three runs each: cuda "
        f"{' '.join(f'{t:.3f}' for t in t_cs)} (pair scoring of the first "
        f"{routes[0].seconds:.3f}) decoys-first cuda "
        f"{' '.join(f'{t:.3f}' for t in t_fs)}; torch over every read "
        f"{t_t:.3f}; numpy over every {NUMPY_READ_STRIDE}th read {t_n:.3f}")
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


def chain_cn_system(rng, k: int):
    """A k-segment chain's balance program (sequence and concordant edges;
    ``tests/test_cn_solver.py::_random_system``): n = 2k - 1 variables and
    2(k - 1) rows, so n + m = 4k - 3."""
    n = 2 * k - 1
    wcn = np.abs(rng.normal(50, 10, n)) + 5
    wlncn = np.concatenate([np.full(k, -0.5),
                            np.abs(rng.normal(300, 50, k - 1))])
    wlrseg = np.concatenate([np.abs(rng.normal(5e4, 1e4, k)),
                             np.zeros(k - 1)])
    A = np.zeros((2 * (k - 1), n))
    for j in range(k - 1):
        A[2 * j][j] = 1
        A[2 * j][k + j] = -1
        A[2 * j + 1][j + 1] = 1
        A[2 * j + 1][k + j] = -1
    return wlrseg, wcn, wlncn, A


def chain_cn_systems():
    """Phase 4f's seeded chain systems, 3 to 120 segments each."""
    rng = np.random.default_rng(43)
    return [chain_cn_system(rng, int(k))
            for k in rng.integers(3, 121, CN_SYSTEMS)]


def _digits(x):
    return ["%f" % (2 * v) for v in x]


def phase_cn_batch(rec, scoring, work: str) -> None:
    """4f: the batched CN engine on the card.  The WGS sample's graphs as
    4a built them, through ``compute_cn(engine="batch")`` and ``numpy``;
    then seeded chain systems solved together against the numpy engine,
    and the two timed from 1 to 256 systems."""
    import torch

    from coral_tpu_torch.graph import cn_solver
    from coral_tpu_torch.graph.breakpoint_graph import write_graph_file

    before = scoring["before_cn"]
    kept = rec.graphs
    secs = {}
    for engine in ("batch", "numpy"):
        secs[engine] = []
        for _ in range(3):
            rec.graphs = copy.deepcopy(before)
            t0 = time.perf_counter()
            rec.compute_cn(engine=engine)
            secs[engine].append(time.perf_counter() - t0)
        for gi, g in enumerate(rec.graphs):
            write_graph_file(g, os.path.join(
                work, f"cn_{engine}_amplicon{gi + 1}_graph.txt"))
    rec.graphs = kept
    for gi in range(len(before)):
        name = f"amplicon{gi + 1}_graph.txt"
        for a, b in (("cn_batch_", "cn_numpy_"), ("cn_batch_", "cuda_")):
            require(filecmp.cmp(os.path.join(work, a + name),
                                os.path.join(work, b + name), shallow=False),
                    f"{a + name} != {b + name}")
    sizes = []
    for g in before:
        w = cn_solver._lr_weights(g, rec.normal_cov)[1]
        A = cn_solver._balance_matrix(g, len(w))
        sizes.append(len(w) + (0 if A is None else A.shape[0]))
    st = scoring["stages"]
    log(f"[4f cn] WGS sample, {len(before)} graphs (n + m "
        f"{sorted(sizes)}): graph files batch (cuda) == numpy == 4a's; "
        f"compute_cn s, three runs each: batch "
        f"{' '.join(f'{t:.4f}' for t in secs['batch'])} numpy "
        f"{' '.join(f'{t:.4f}' for t in secs['numpy'])}; 4a's graph+cn "
        f"stage (CN auto) {st['graph+cn']} s")

    systems = chain_cn_systems()
    torch.cuda.reset_peak_memory_stats()
    xs = cn_solver.solve_cn_balance_batch(systems, device="cuda")
    peak = torch.cuda.max_memory_allocated()
    per_system = []
    worst = 0.0
    for s, x in zip(systems, xs):
        t0 = time.perf_counter()
        want = cn_solver.solve_cn_balance(*s, engine="numpy", device="cpu")
        per_system.append(time.perf_counter() - t0)
        require(_digits(x) == _digits(want),
                f"batch != numpy in a digit (n = {len(s[1])})")
        worst = max(worst, float(np.max(np.abs(x - want) / np.abs(want))))
    n_max = max(len(s[1]) + s[3].shape[0] for s in systems)
    log(f"[4f cn] {CN_SYSTEMS} chain systems, n + m up to {n_max}: batch "
        f"(cuda) == numpy in every digit, largest relative error {worst:.3e}"
        f"; peak device memory {peak / 2**20:.1f} MiB")
    rows = []
    for b in CN_BATCHES:
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            cn_solver.solve_cn_balance_batch(systems[:b], device="cuda")
            times.append(time.perf_counter() - t0)
        rows.append((b, float(np.median(times)), sum(per_system[:b])))
    wins = [b for b, t_batch, t_np in rows if t_batch < t_np]
    log("[4f cn] s, batch on the card (median of 3) / numpy loop: " + "; ".join(
        f"B={b} {t_batch:.4f} / {t_np:.4f}" for b, t_batch, t_np in rows))
    log(f"[4f cn] batch wins from B={wins[0] if wins else 'none'} of "
        f"{list(CN_BATCHES)}; cfg.engine.cn_batch_threshold is "
        f"{rec.cfg.engine.cn_batch_threshold}")


def phase_fused_step(rec, scoring) -> dict:
    """4g: the fused scoring step, ``make_fused_step`` with the ``cuda``
    engine (K4) against ``torch`` and the numpy twin, on the WGS sample's
    unpacked pairs over its intervals and with the decoys first.  Returns
    the launch counts of the ``cuda`` steps' run."""
    import torch

    from coral_tpu_torch.ops import kernels
    from coral_tpu_torch.ops.scoring import make_fused_step, \
        make_fused_step_numpy

    table, pi, span = scoring["table"], scoring["pi"], scoring["span"]
    cols = _unpacked_columns(table, pi, span)
    reads = scoring["starts"], scoring["ends"]
    dev = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
           for a in (*reads, *cols)]
    real = [list(iv) for iv in rec.amplicon_intervals]
    lists = (("its intervals", real),
             ("8,190 decoys first", decoy_intervals(N_DECOYS) + real))
    tables = [_interval_arrays(ivs, span) for _, ivs in lists]
    torch.cuda.synchronize()

    # this path's run: counters from zero, the cuda steps only
    kernels.reset_launches()
    got = []
    for ints in tables:
        got.append(make_fused_step(*ints, "cuda", device="cuda")(*dev))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    require(launches["pair6_support"] == len(lists),
            f"K4 launches != steps: {launches}")

    sample = slice(None, None, FUSED_SAMPLE)
    for (name, ivs), ints, (sup_c, cov_c) in zip(lists, tables, got):
        sup_t, cov_t = make_fused_step(*ints, "torch", device="cuda")(*dev)
        require(torch.equal(sup_c, sup_t), f"{name}: cuda support != torch")
        require(torch.equal(cov_c, cov_t), f"{name}: cuda coverage != torch")
        sup_c, cov_c = sup_c.cpu().numpy(), cov_c.cpu().numpy()
        require(np.array_equal(sup_c[-len(real):], scoring["support_v3"]),
                f"{name}: support != K2's of 4a")
        require(np.array_equal(cov_c[-len(real):], scoring["cov_v3"]),
                f"{name}: coverage != 4a's")
        # the numpy twin: every pair over the sample's intervals, every
        # 64th over the long list, with the cuda and torch steps on those
        part = sample if len(ivs) > len(real) else slice(None)
        sub = [c[part] for c in cols]
        sup_n, cov_n = make_fused_step_numpy(*ints)(*reads, *sub)
        sub_dev = [torch.from_numpy(np.ascontiguousarray(c)).cuda()
                   for c in sub]
        for engine in ("cuda", "torch"):
            s_e, c_e = make_fused_step(*ints, engine, device="cuda")(
                *dev[:2], *sub_dev)
            require(np.array_equal(s_e.cpu().numpy(), sup_n),
                    f"{name}: {engine} support != numpy on the pairs "
                    f"{part}")
            require(np.array_equal(c_e.cpu().numpy(), cov_n),
                    f"{name}: {engine} coverage != numpy")
        step = make_fused_step(*ints, "cuda", device="cuda")
        ms = cuda_ms(lambda: step(*dev))
        log(f"[4g fused] {name} ({len(ivs)}), {len(pi)} pairs, "
            f"{len(reads[0])} reads: cuda (K4) == torch, == numpy on "
            f"{len(sub[0])} pairs; support of the sample's intervals "
            f"{sup_c[-len(real):].tolist()} == K2's of 4a, coverage == 4a's;"
            f" cuda step {ms:.4f} ms (packing, K4, int64 coverage tables)")
    log(f"[4g fused] launches in the cuda steps' run: {launches}")
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


# -- phase 6 --------------------------------------------------------------

def _cycles_agree(path_a: str, path_b: str) -> bool:
    """Two cycles files are the same line for line but for the copy
    counts, which they print to the last bit (``repr``) and which agree to
    rtol 1e-9: the decomposition reads CN values that two CN engines give
    to the same printed digits, not to the same bits."""
    pat = re.compile(r"Copy_count=([^;]+)")
    with open(path_a) as fa, open(path_b) as fb:
        lines_a, lines_b = fa.read().splitlines(), fb.read().splitlines()
    if len(lines_a) != len(lines_b):
        return False
    for a, b in zip(lines_a, lines_b):
        ca, cb = pat.findall(a), pat.findall(b)
        if pat.sub("", a) != pat.sub("", b) or len(ca) != len(cb):
            return False
        if not np.allclose(np.float64(ca), np.float64(cb), rtol=1e-9,
                           atol=0):
            return False
    return True


def phase_user_pipeline(work: str) -> None:
    """``seed`` -> ``reconstruct`` (``cuda``, ``batch``; and ``numpy``,
    ``numpy``) -> ``cycle2bed`` through the port's CLI."""
    from coral_tpu_torch.sim import simulate_mixed_sample

    bam, cns, _ = simulate_mixed_sample(work, seed=3)

    def cli(*args):
        subprocess.run([sys.executable, "-m", "coral_tpu_torch", *args],
                       cwd=ROOT, check=True, stdout=subprocess.DEVNULL,
                       timeout=600)

    seeds = os.path.join(work, "seeds.bed")
    cli("seed", "--cn_seg", cns, "--out", seeds)
    with open(seeds) as fh:
        n_seeds = len(fh.read().splitlines())
    require(n_seeds > 0, "seed wrote no interval")
    secs = {}
    for name, engine, cn_engine in (("dev", "cuda", "batch"),
                                    ("host", "numpy", "numpy"),
                                    ("hostb", "numpy", "batch")):
        t0 = time.perf_counter()
        cli("reconstruct", "--lr_bam", bam, "--cnv_seed", seeds,
            "--cn_seg", cns, "--output_prefix", os.path.join(work, name),
            "--engine", engine, "--cn_engine", cn_engine, "--device", "cuda",
            "--log_fn", os.path.join(work, f"{name}.log"))
        secs[name] = time.perf_counter() - t0
    outs = sorted(f for f in os.listdir(work) if f.startswith("dev_")
                  and f.endswith(("_graph.txt", "_cycles.txt")))
    cycles = [f for f in outs if f.endswith("_cycles.txt")]
    require(cycles, "no cycles files")
    for f in outs:
        require(filecmp.cmp(os.path.join(work, f),
                            os.path.join(work, "hostb" + f[3:]),
                            shallow=False), f"{f}: cuda+batch != numpy+batch")
        if f.endswith("_graph.txt"):
            require(filecmp.cmp(os.path.join(work, f),
                                os.path.join(work, "host" + f[3:]),
                                shallow=False), f"{f}: cuda+batch != numpy")
        else:
            require(_cycles_agree(os.path.join(work, f),
                                  os.path.join(work, "host" + f[3:])),
                    f"{f}: cuda+batch cycles != numpy's")
    with open(os.path.join(work, "dev.log")) as fh:
        text = fh.read()
    require("CN balance route: engine=batch" in text,
            "the CLI run did not take the batch CN engine")
    require(any("pair scoring route" in ln and "engine=cuda" in ln
                for ln in text.splitlines()),
            "the CLI run did not score with cuda")
    n_rows = 0
    for f in cycles:
        for flags in ([], ["--rotate_to_min"]):
            bed = os.path.join(work, f"{f}{len(flags)}.bed")
            cli("cycle2bed", "--cycle_fn", os.path.join(work, f),
                "--output_fn", bed, *flags)
            with open(bed) as fh:
                rows = [ln for ln in fh if not ln.startswith("#")]
            require(rows, f"cycle2bed wrote no row for {f}")
            n_rows += len(rows)
    log(f"[6 pipeline] mixed sample: seed wrote {n_seeds} intervals; "
        f"reconstruct from them: {len(outs)} graph+cycles files identical "
        f"cuda+batch == numpy+batch, graph files identical to numpy+numpy "
        f"and its cycles files but for copy counts within rtol 1e-9 (CLI s "
        f"{secs['dev']:.2f} / {secs['host']:.2f} / {secs['hostb']:.2f}); "
        f"cycle2bed, plain and rotated, {n_rows} rows")


# -- phase 7 --------------------------------------------------------------

MESH_SHARDS = (1, 2, 4)   # shards of cuda:0 for pair scoring
BIN_SHARDS = 4            # read shards for coverage (and a 2 x 2 mesh)
SCAN_SHARDS = (2, 4)      # BAM shards, one scanning process each


def _same_files(dir_a, prefix_a, dir_b, prefix_b, kinds=("graph",)):
    """The ``*_amplicon<k>_<kind>.txt`` files under ``prefix_a`` equal those
    under ``prefix_b``, byte for byte; returns how many were compared."""
    names = sorted(f[len(prefix_a):] for f in os.listdir(dir_a)
                   if f.startswith(prefix_a + "_amplicon")
                   and f.endswith(tuple(f"_{k}.txt" for k in kinds)))
    require(names, f"no output files under {prefix_a}")
    for name in names:
        require(filecmp.cmp(os.path.join(dir_a, prefix_a + name),
                            os.path.join(dir_b, prefix_b + name),
                            shallow=False),
                f"{prefix_a}{name} != {prefix_b}{name}")
    return len(names)


@contextlib.contextmanager
def merge_ends(multihost, into: list):
    """While active, the time at which each ``merge_scan_products`` inside
    ``multihost_reconstruct_graphs`` returns is appended to ``into``."""
    inner = multihost.merge_scan_products

    def timed(*args, **kw):
        out = inner(*args, **kw)
        into.append(time.perf_counter())
        return out

    multihost.merge_scan_products = timed
    try:
        yield
    finally:
        multihost.merge_scan_products = inner


def _spread(xs):
    return (f"median {np.median(xs):.6f} (min {min(xs):.6f}, max "
            f"{max(xs):.6f}; {' '.join(f'{x:.6f}' for x in xs)})")


def _run_ranks(argv_of_rank, n: int, work: str, timeout: int):
    """One process a rank; returns their (returncode, stdout, stderr),
    every process killed if any outlives ``timeout`` s."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, *argv_of_rank(r)], cwd=work,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(n)]
    out = []
    try:
        for p in procs:
            sout, serr = p.communicate(timeout=timeout)
            out.append((p.returncode, sout, serr))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def phase_parallel(rec, scoring, work: str):
    """7: the mesh and multi-process layer on the card.  Pair scoring
    sharded over 1, 2 and 4 shards of cuda:0 (K1 over the sample's 10
    intervals, K3 over 8,200 with the decoys first, the torch engine),
    reconstruct on a mesh, bin coverage over 4 read shards and a 2 x 2
    mesh (K8), the batch CN engine over 4 shards, the BAM split into 2 and
    4 shards scanned by as many processes, a 2-process gloo group through
    the pipeline worker, and a 1-process nccl group.  Returns the launch
    counts of this phase's sharded paths."""
    import torch
    import torch.distributed as tdist

    from coral_tpu_torch.graph import cn_solver
    from coral_tpu_torch.ops import kernels
    from coral_tpu_torch.ops.coverage import bin_coverage, \
        bin_coverage_sharded
    from coral_tpu_torch.ops.pairs import score_pairs_l
    from coral_tpu_torch.parallel import distributed, make_mesh, multihost
    from coral_tpu_torch.parallel.mesh import Mesh
    from coral_tpu_torch.parallel.sharded import score_pairs_sharded
    from coral_tpu_torch.reconstruct import reconstruct_cycles, \
        reconstruct_graphs
    from coral_tpu_torch.sim import simulate_mixed_sample

    cfg_b = rec.cfg.bp
    table = scoring["table"]
    bam, cns, seeds = scoring["inputs"]
    real = [list(iv) for iv in rec.amplicon_intervals]
    lists = {"10 intervals (K1)": real,
             "8,200 decoys first (K3)": decoy_intervals(N_DECOYS) + real}
    args = (cfg_b.min_bp_match_cutoff, cfg_b.min_mapq, 100)
    n_bins = -(-WGS_CHR_LEN // COVERAGE_BIN)
    spans = []
    for rid in range(len(rec.bam.references)):
        rows = rec.bam.ref_id == rid
        spans.append((rec.bam.pos[rows].astype(np.int32),
                      rec.bam.end[rows].astype(np.int32)))
    systems = chain_cn_systems()

    # what the sharded paths are held to: one device, before the counts
    # are set to zero
    single, t_single = {}, {}
    for name, ivs in lists.items():
        t0 = time.perf_counter()
        single[name] = score_pairs_l(table, ivs, *args, engine="cuda",
                                     device="cuda")[2]
        t_single[name] = time.perf_counter() - t0
    require(np.array_equal(single["10 intervals (K1)"],
                           single["8,200 decoys first (K3)"]),
            "K1 and K3 routes disagree on one device")
    hists = [bin_coverage(s, e, 0, COVERAGE_BIN, n_bins, engine="cuda",
                          device="cuda") for s, e in spans]
    xs_single = cn_solver.solve_cn_balance_batch(systems, device="cuda")
    graphs_single = copy.deepcopy(scoring["before_cn"])
    cn_solver.compute_cn_batch(graphs_single, rec.normal_cov, device="cuda")

    def cn_digits(graphs):
        return [["%f" % e.cn for edges in (g.sequence_edges,
                                           g.concordant_edges,
                                           g.discordant_edges, g.source_edges)
                 for e in edges] for g in graphs]

    kernels.reset_launches()
    # pair scoring over shards of the one card
    t_shard = {}
    for name, ivs in lists.items():
        for n in MESH_SHARDS:
            mesh = make_mesh(devices=["cuda:0"] * n)
            t0 = time.perf_counter()
            hit = score_pairs_sharded(table, ivs, *args, mesh,
                                      engine="cuda")[2]
            t_shard[name, n] = time.perf_counter() - t0
            require(np.array_equal(hit, single[name]),
                    f"score_pairs_sharded(cuda), {n} shards, {name} != one "
                    "device")
    t0 = time.perf_counter()
    hit = score_pairs_sharded(table, real, *args,
                              make_mesh(devices=["cuda:0"] * 4),
                              engine="torch")[2]
    t_torch = time.perf_counter() - t0
    require(np.array_equal(hit, single["10 intervals (K1)"]),
            "score_pairs_sharded(torch), 4 shards != one device")
    log(f"[7 parallel] score_pairs_sharded == score_pairs_l on one device "
        f"over {len(hit)} pairs, host s: " + "; ".join(
            f"{name}: one device {t_single[name]:.3f}, " + ", ".join(
                f"{n} shards {t_shard[name, n]:.3f}" for n in MESH_SHARDS)
            for name in lists) + f"; torch engine, 4 shards {t_torch:.3f}")

    # reconstruct with pair scoring and CN on a mesh of one card
    t0 = time.perf_counter()
    rec_m = reconstruct_graphs(bam, seeds, cns, os.path.join(work, "mesh"),
                               cfg=scoring["cfg"],
                               mesh=make_mesh(devices=["cuda:0"]),
                               device="cuda")
    rec_m.bam.close()
    t_mesh = time.perf_counter() - t0
    n_files = _same_files(work, "mesh", work, "cuda")
    log(f"[7 parallel] reconstruct_graphs(mesh=[cuda:0]): {n_files} graph "
        f"files identical to 4a's run without a mesh; {t_mesh:.3f} s")

    # coverage over read shards, and over a 2 x 2 mesh splitting the bins
    devs = np.empty(4, dtype=object)
    devs[:] = [torch.device("cuda:0")] * 4
    meshes = {f"{BIN_SHARDS} read shards":
              (make_mesh(devices=["cuda:0"] * BIN_SHARDS), None),
              "2 x 2 (reads x bins)": (Mesh(devs.reshape(2, 2),
                                            ("dp", "sp")), "sp")}
    t_bins = {}
    for name, (mesh, genome_axis) in meshes.items():
        t0 = time.perf_counter()
        for (s, e), want in zip(spans, hists):
            got = bin_coverage_sharded(s, e, 0, COVERAGE_BIN, n_bins, mesh,
                                       genome_axis=genome_axis,
                                       engine="cuda")
            require(got.dtype == np.int64 and np.array_equal(got, want),
                    f"bin_coverage_sharded, {name} != bin_coverage")
        t_bins[name] = time.perf_counter() - t0
    log(f"[7 parallel] bin_coverage_sharded(cuda) == bin_coverage on "
        f"{len(spans)} chromosomes x {n_bins} bins, s: " + ", ".join(
            f"{k} {v:.3f}" for k, v in t_bins.items()))

    # the batch CN engine over four shards of the card
    mesh4 = make_mesh(devices=["cuda:0"] * 4)
    t0 = time.perf_counter()
    xs = cn_solver.solve_cn_balance_batch(systems, mesh=mesh4)
    t_cn = time.perf_counter() - t0
    require(all(_digits(a) == _digits(b) for a, b in zip(xs, xs_single))
            and len(xs) == len(xs_single),
            "CN over 4 shards != one batch in a digit")
    graphs = copy.deepcopy(scoring["before_cn"])
    cn_solver.compute_cn_batch(graphs, rec.normal_cov, mesh=mesh4)
    require(cn_digits(graphs) == cn_digits(graphs_single),
            "compute_cn_batch over 4 shards != one batch in a digit")
    log(f"[7 parallel] CN batch over 4 shards: {len(systems)} chain systems "
        f"({t_cn:.3f} s) and the sample's {len(graphs)} graphs, every digit "
        "of the single batch")

    # the BAM split into shards, one scanning process each: the whole
    # pipeline once a shard count through the scaling tool's loop, its
    # scan and merge timed
    scan_s, ends = {}, []
    with merge_ends(multihost, ends):
        for row in bench_multihost.scaling(bam, seeds, cns, work,
                                           ns=SCAN_SHARDS, reps=1,
                                           cfg=scoring["cfg"],
                                           device="cuda"):
            k = row["processes"]
            row["rec"].bam.close()
            require(len(ends) == 1, "merge_scan_products not called once")
            scan_s[k] = ends.pop() - row["started"]
            _same_files(work, os.path.basename(row["prefix"]), work, "cuda")
            log(f"[7 scan] {k} shards: split {row['split_s']:.3f} s; "
                f"multihost_reconstruct_graphs {row['wall_s']:.3f} s, graph "
                "files identical to 4a's")
    st = scoring["stages"]
    log("[7 scan] fanned-out scan + merge, s: " + "; ".join(
        f"{k} shards {v:.3f}" for k, v in scan_s.items())
        + f"; 4a's single-process scan+collect cuda "
        f"{st['scan+collect']:.3f}, numpy "
        f"{scoring['stages_numpy']['scan+collect']:.3f}")
    launches = dict(kernels.LAUNCHES)

    # a 1-process nccl group: the sum stays on the card, K8 per process
    distributed.initialize("file://" + os.path.join(work, "rdzv_nccl"), 1,
                           0, backend="nccl", device="cuda:0")
    kernels.reset_launches()
    try:
        total = distributed.allreduce_sum(np.array([2**40 + 5, -7]))
        require(total.tolist() == [2**40 + 5, -7], f"allreduce: {total}")
        require(distributed.allgather_bytes(b"nccl") == [b"nccl"],
                "allgather_bytes")
        hist = distributed.shard_bin_histogram(bam, WGS_CHROMS[0], 0,
                                               COVERAGE_BIN, n_bins)
        require(np.array_equal(hist, hists[0]),
                "shard_bin_histogram (nccl) != bin_coverage")
    finally:
        tdist.destroy_process_group()
    for k, v in kernels.LAUNCHES.items():
        launches[k] += v
    log(f"[7 nccl] 1-process group: allreduce_sum int64, allgather_bytes, "
        f"shard_bin_histogram of {WGS_CHROMS[0]} == bin_coverage")
    # two ranks on the one card: refused before any nccl collective
    code = ("import sys\nfrom coral_tpu_torch.parallel.distributed import "
            "initialize\ninitialize(sys.argv[1], 2, int(sys.argv[2]), "
            "backend='nccl', device='cuda:0')\n")
    rdzv = "file://" + os.path.join(work, "rdzv_nccl2")
    outs = _run_ranks(lambda r: ["-c", code, rdzv, str(r)], 2, work, 300)
    require(all(rc != 0 and "one card per process" in err
                for rc, _, err in outs),
            f"nccl with two ranks on one card did not raise: {outs}")
    log("[7 nccl] two ranks on one card: both raise 'one card per process'")

    # a 2-process gloo group, both ranks on the card, through the pipeline
    # worker: on the mixed sample (the WGS sample's Python merge repeated
    # in each rank would add more than 150 s; PERF.md section 4)
    mixed = os.path.join(work, "mixed")
    os.makedirs(mixed)
    m_bam, m_cns, m_seeds = simulate_mixed_sample(mixed, seed=3)
    rec_s = reconstruct_graphs(m_bam, m_seeds, m_cns,
                               os.path.join(mixed, "single"), device="cuda")
    reconstruct_cycles(rec_s, os.path.join(mixed, "single"))
    rec_s.bam.close()
    shards = multihost.split_bam(
        m_bam, [os.path.join(mixed, f"s{i}.bam") for i in range(2)])
    rdzv = "file://" + os.path.join(mixed, "rdzv_gloo")
    t0 = time.perf_counter()
    outs = _run_ranks(lambda r: [
        "-m", "coral_tpu_torch.parallel.distributed", "pipeline", str(r),
        "2", rdzv, "gloo", "cuda:0", m_seeds, m_cns,
        os.path.join(mixed, "dist"), *shards], 2, mixed, 600)
    t_group = time.perf_counter() - t0
    for r, (rc, sout, serr) in enumerate(outs):
        require(rc == 0, f"gloo rank {r} failed:\n{sout}\n{serr[-3000:]}")
        n_files = _same_files(mixed, f"dist.p{r}", mixed, "single",
                              ("graph", "cycles"))
    log(f"[7 gloo] 2 processes on cuda:0, mixed sample: each rank's "
        f"{n_files} graph and cycles files identical to the single-process "
        f"run; {t_group:.3f} s")
    log(f"[7 parallel] launches in this phase's sharded paths: {launches}")
    # K1 per shard, once on the mesh of one card, once a multihost run; K3
    # per shard and its index once a call; K8 per shard and chromosome
    expect = {"pair3": sum(MESH_SHARDS) + 1 + len(SCAN_SHARDS),
              "pair6": sum(MESH_SHARDS), "interval_index": len(MESH_SHARDS),
              "bin_overlap": 2 * BIN_SHARDS * len(spans) + 1}
    for k, want in expect.items():
        require(launches[k] == want,
                f"{k}: {launches[k]} launches, {want} expected")
    return launches


# -- phase 8 --------------------------------------------------------------

PIPE_CHUNK = 1 << 18      # pairs a chunk of the pipelined scorer
PIPE_CHUNKS = 6           # the WGS sample's 1.5 M pairs, padded
TIMED_RUNS = 3
NEVER_LOSES_S = 2.0       # bench.py's e2e_wgs_auto_never_loses margin
SR_LENGTH = 150.0


def phase_pipelined(rec, scoring):
    """8a: ``make_pipelined_scorer`` on the WGS sample's pairs, packed by
    the native ``pack_pairs3`` and padded to six chunks of 2^18: ``cuda``
    (K2 a chunk) against 4a's support and coverage and against the
    ``torch`` engine on the card, then timed against the monolithic
    ``make_batch_scorer(engine="cuda")`` with its pageable copies, and the
    copies alone.  Returns the launch counts of its run."""
    import torch

    from coral_tpu_torch.native.bamcore import pack_pairs3
    from coral_tpu_torch.ops import kernels
    from coral_tpu_torch.ops.scoring import make_batch_scorer, \
        make_pipelined_scorer

    table, pi, span = scoring["table"], scoring["pi"], scoring["span"]
    n_pad = PIPE_CHUNKS * PIPE_CHUNK
    require(n_pad - PIPE_CHUNK < len(pi) <= n_pad,
            f"{len(pi)} pairs do not fill {PIPE_CHUNKS} chunks")
    ic, is_, ie = _interval_arrays(rec.amplicon_intervals)
    _, lin_s, lin_e = _interval_arrays(rec.amplicon_intervals, span)
    t0 = time.perf_counter()
    packed = pack_pairs3(pi, table.q_start, table.q_end, table.r1, table.r2,
                         table.chrom, table.strand, table.mapq, ic, is_, ie,
                         min_mapq=MIN_MAPQ, n_out=n_pad)
    t_pack = time.perf_counter() - t0
    starts, ends = scoring["starts"], scoring["ends"]
    build, stream = make_pipelined_scorer(ic, lin_s, lin_e, chunk=PIPE_CHUNK,
                                          engine="cuda", device="cuda")
    tables = build(starts, ends)
    torch.cuda.synchronize()
    # this path's run: counters from zero
    kernels.reset_launches()
    sup, cov = stream(tables, packed)
    sup, cov = sup.cpu().numpy(), cov.cpu().numpy()
    launches = dict(kernels.LAUNCHES)
    require(launches["pair3_support"] == PIPE_CHUNKS,
            f"K2 launched {launches['pair3_support']} times, not once a "
            "chunk")
    require(sum(launches.values()) == PIPE_CHUNKS,
            f"other kernels in the pipelined run: {launches}")
    require(np.array_equal(sup, scoring["support_v3"]),
            "pipelined support != 4a's K2 support")
    require(cov.dtype == np.int64 and np.array_equal(cov, scoring["cov_v3"]),
            "pipelined coverage != 4a's")
    build_t, stream_t = make_pipelined_scorer(
        ic, lin_s, lin_e, chunk=PIPE_CHUNK, engine="torch", device="cuda")
    sup_t, cov_t = stream_t(build_t(starts, ends), packed)
    require(np.array_equal(sup_t.cpu().numpy(), sup)
            and np.array_equal(cov_t.cpu().numpy(), cov),
            "pipelined cuda != torch engine on the card")

    build_m, score_m = make_batch_scorer(ic, lin_s, lin_e, "cuda",
                                         device="cuda")
    tables_m = build_m(starts, ends)

    def host_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    def pipelined():
        return [x.cpu() for x in stream(tables, packed)]

    def monolithic():
        return [x.cpu() for x in score_m(tables_m, *packed)]

    pageable = [np.ascontiguousarray(c) for c in packed]
    pinned = torch.empty((3, n_pad), dtype=torch.int32, pin_memory=True)
    pinned.numpy()[:] = np.stack(packed)
    dev_buf = torch.empty((3, n_pad), dtype=torch.int32, device="cuda")

    def copies_pageable():
        return [torch.from_numpy(c).to("cuda") for c in pageable]

    def copies_pinned():
        return dev_buf.copy_(pinned, non_blocking=True)

    stage = torch.empty((3, PIPE_CHUNK), dtype=torch.int32, pin_memory=True)

    def copies_staged():
        # the pipelined scorer's copies without its kernels: each chunk
        # through one pinned staging buffer, in turn
        for k in range(PIPE_CHUNKS):
            torch.cuda.current_stream().synchronize()
            for dst, col in zip(stage.numpy(), packed):
                np.copyto(dst, col[k * PIPE_CHUNK:(k + 1) * PIPE_CHUNK])
            dev_buf[:, :PIPE_CHUNK].copy_(stage, non_blocking=True)

    arms = {"pipelined": pipelined, "monolithic": monolithic,
            "copies pageable": copies_pageable,
            "copies pinned": copies_pinned,
            "copies staged": copies_staged}
    for fn in arms.values():
        fn()      # warm: allocator blocks, pinned pages
    times = {k: [] for k in arms}
    for _ in range(TIMED_RUNS):
        for k, fn in arms.items():
            t, out = host_s(fn)
            times[k].append(t)
            if k in ("pipelined", "monolithic"):
                require(np.array_equal(out[0].numpy(), sup)
                        and np.array_equal(out[1].numpy(), cov),
                        f"{k}: support or coverage moved between runs")
    nbytes = 12 * n_pad
    rates = {k: nbytes / float(np.median(times[k])) / 1e9
             for k in ("copies pageable", "copies pinned")}
    log(f"[8a pipelined] {len(pi)} pairs packed by the native pack_pairs3 "
        f"into {PIPE_CHUNKS} x {PIPE_CHUNK} in {t_pack:.3f} s; cuda: K2 "
        f"launched {launches['pair3_support']} times, support "
        f"{sup.tolist()} == 4a's K2, coverage == 4a's (int64), == the torch "
        "engine on the card")
    log("[8a pipelined] host s over " + f"{nbytes} B, {TIMED_RUNS} runs "
        "each: " + "; ".join(f"{k} {_spread(v)}" for k, v in times.items()))
    log(f"[8a pipelined] H2D of the {nbytes} B: pageable "
        f"{rates['copies pageable']:.2f} GB/s, pinned "
        f"{rates['copies pinned']:.2f} GB/s; pipelined / monolithic "
        f"{np.median(times['pipelined']) / np.median(times['monolithic']):.3f}")
    return launches


def _route_args(rec):
    """``Reconstruction.find_breakpoints``'s arguments to
    ``find_breakpoints_device``, ahead of the engine."""
    cfg_b = rec.cfg.bp
    max_nm = (rec.nm_stats[0] + 3 * rec.nm_stats[1]
              if cfg_b.nm_filter else None)
    return (rec.chimeras, rec.amplicon_intervals, cfg_b.min_bp_match_cutoff,
            cfg_b.min_mapq, 100, cfg_b.gap_mapq, max_nm)


def cold_auto_arm(bam, cns, seeds, empty_dir, out):
    """8b's cold arm, in a fresh process (``python -c``, from phase 8): the
    reconstruct stages up to the breakpoints, then
    ``find_breakpoints_device(engine="auto")`` with the build directory
    pointed at ``empty_dir``, which holds only copies of the checkout's
    host libraries.  Then, in the same process, the config's threshold
    through ``Reconstruction.find_breakpoints``, and what the
    load costs: ``dlopen`` of the built library, the first CUDA context,
    and a first ``cuda`` scoring call against a second.  Pickles (BpTable,
    results) to ``out``."""
    import pickle
    import shutil
    from pathlib import Path

    import torch

    from coral_tpu_torch import _buildlib
    from coral_tpu_torch.config import DEFAULT_CONFIG
    from coral_tpu_torch.io.bam import BamFile
    from coral_tpu_torch.native import _build as host_build
    from coral_tpu_torch.ops import _build, routing
    from coral_tpu_torch.ops import pairs as pairs_mod
    from coral_tpu_torch.reconstruct import Reconstruction

    # the host libraries as the checkout has them; none of the kernels
    host_libs = [shutil.copy(host_build.build(name), empty_dir)
                 for name in ("bamcore", "walkenum")]
    real_dir, _buildlib.BUILD_DIR = _buildlib.BUILD_DIR, Path(empty_dir)
    calls = []
    for name in ("build", "load"):
        def counted(*a, _inner=getattr(_build, name), _name=name, **kw):
            calls.append(_name)
            return _inner(*a, **kw)
        setattr(_build, name, counted)
    decisions = []
    inner_decide = routing.decide

    def decide(*a, **kw):
        got = inner_decide(*a, **kw)
        decisions.append(dict(state=routing.library_state(),
                              cuda_initialized=torch.cuda.is_initialized(),
                              calls=list(calls)))
        return got

    routing.decide = decide
    res = {}
    rec = Reconstruction(BamFile(bam), seeds, DEFAULT_CONFIG, device="cuda")
    rec.read_cns(cns)
    rec.collect()
    rec.hash_to_segments()
    rec.find_amplicon_intervals()
    seq = pairs_mod.last_route_seq()
    table = pairs_mod.find_breakpoints_device(
        *_route_args(rec), engine="auto", as_table=True, device="cuda")
    (r,) = pairs_mod.route_records_since(seq)
    res["cold"] = dict(engine=r.engine, reason=r.reason, seconds=r.seconds,
                       decisions=decisions,
                       built=sorted(set(os.listdir(empty_dir))
                                    - {os.path.basename(p)
                                       for p in host_libs}),
                       cuda_initialized=torch.cuda.is_initialized())
    rec.cfg = rec.cfg.replace(engine=dataclasses.replace(
        rec.cfg.engine, device_pair_threshold=10 ** 12))
    seq = pairs_mod.last_route_seq()
    rec.find_breakpoints()
    (r,) = pairs_mod.route_records_since(seq)
    res["threshold"] = dict(engine=r.engine, reason=r.reason,
                            cuda_initialized=torch.cuda.is_initialized())
    res["calibration"] = dataclasses.asdict(routing.get_calibration())

    _buildlib.BUILD_DIR = real_dir
    load = dict(state=routing.library_state())
    t0 = time.perf_counter()
    _build.load()
    load["dlopen_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    load["context_s"] = time.perf_counter() - t0
    for k in ("first_s", "second_s"):
        seq = pairs_mod.last_route_seq()
        pairs_mod.find_breakpoints_device(*_route_args(rec), engine="cuda",
                                          as_table=True, device="cuda")
        load[k] = pairs_mod.route_records_since(seq)[0].seconds
    load["cold_s"] = load["dlopen_s"] + load["context_s"] \
        + load["first_s"] - load["second_s"]
    res["load"] = load
    rec.bam.close()
    with open(out, "wb") as fh:
        pickle.dump((table, res), fh)


def phase_routing(rec, scoring, work: str) -> None:
    """8b: ``auto`` routing on the WGS sample, three arms of the
    breakpoints stage: ``numpy`` forced; ``auto`` in a fresh process whose
    kernels' library is absent (must stay on the host for ``cold``, build
    nothing and create no CUDA context); ``auto`` here, the library loaded
    and one observation recorded (must go to the card).  The three
    BpTables identical, and no ``auto`` arm's scoring more than
    NEVER_LOSES_S above the numpy arm's.  In the fresh process also the
    config's threshold through ``Reconstruction`` and the load's cost."""
    import pickle

    from coral_tpu_torch.ops import pairs as pairs_mod
    from coral_tpu_torch.ops import routing

    args = _route_args(rec)

    def arm(engine):
        seq = pairs_mod.last_route_seq()
        tb = pairs_mod.find_breakpoints_device(*args, engine=engine,
                                               as_table=True, device="cuda")
        (r,) = pairs_mod.route_records_since(seq)
        return tb, r

    tb_n, r_n = arm("numpy")
    require(r_n.engine == "numpy" and r_n.reason == "forced",
            f"numpy arm: {r_n}")

    empty = os.path.join(work, "empty_build")
    os.makedirs(empty)
    out = os.path.join(work, "cold_arm.pkl")
    bam, cns, seeds = scoring["inputs"]
    code = ("import sys\nsys.path.insert(0, sys.argv[1])\n"
            "import chip_smoke\nchip_smoke.cold_auto_arm(*sys.argv[2:])\n")
    t0 = time.perf_counter()
    ((rc, sout, serr),) = _run_ranks(
        lambda _: ["-c", code, ROOT, bam, cns, seeds, empty, out], 1, work,
        600)
    t_proc = time.perf_counter() - t0
    require(rc == 0, f"cold arm failed:\n{sout}\n{serr[-3000:]}")
    with open(out, "rb") as fh:
        tb_c, res = pickle.load(fh)
    cold, load = res["cold"], res["load"]
    (dec,) = cold["decisions"]
    require(cold["engine"] == "numpy" and "cold (absent)" in cold["reason"],
            f"cold auto arm: {cold}")
    require(dec == dict(state="absent", cuda_initialized=False, calls=[])
            and not cold["built"] and not cold["cuda_initialized"],
            f"the cold decision built, loaded or touched the card: {cold}")
    thr = res["threshold"]
    require(thr["engine"] == "numpy" and "threshold" in thr["reason"]
            and not thr["cuda_initialized"],
            f"EngineConfig(device_pair_threshold=10**12): {thr}")
    require(load["state"] == "built", f"load timed from {load['state']}")

    routing.clear_observations()
    _, r_obs = arm("cuda")
    require(r_obs.engine == "cuda" and len(routing._observed) == 1,
            f"one warm cuda call, observations {routing._observed}")
    tb_w, r_w = arm("auto")
    require(r_w.engine == "cuda" and "warm" in r_w.reason
            and "observed" in r_w.reason, f"warm auto arm: {r_w}")
    for name, tb in (("cold auto", tb_c), ("warm auto", tb_w)):
        require(_bp_tables_equal(tb, tb_n), f"{name} BpTable != numpy's")
    never_loses = all(t <= r_n.seconds + NEVER_LOSES_S
                      for t in (cold["seconds"], r_w.seconds))
    require(never_loses, "auto_never_loses is false: numpy "
            f"{r_n.seconds:.3f} s, cold auto {cold['seconds']:.3f}, warm "
            f"auto {r_w.seconds:.3f}")
    cal = routing.get_calibration()
    log(f"[8b routing] {r_n.n_pairs} pairs, pair scoring s: numpy "
        f"{r_n.seconds:.3f}; auto, fresh process, library absent: "
        f"{cold['engine']} {cold['seconds']:.3f} ({cold['reason']}); auto, "
        f"library loaded: {r_w.engine} {r_w.seconds:.3f} ({r_w.reason}); "
        f"BpTables identical; auto_never_loses true")
    log(f"[8b routing] the cold decision: state absent, build/load calls "
        f"{dec['calls']}, torch.cuda.is_initialized() "
        f"{dec['cuda_initialized']}, build directory empty; "
        f"EngineConfig(device_pair_threshold=10**12): {thr['engine']} "
        f"({thr['reason']}); fresh process {t_proc:.1f} s")
    c0 = res["calibration"]
    log(f"[8b routing] calibration: host {cal.host_pairs_per_s:.0f} "
        f"pairs/s (fresh process {c0['host_pairs_per_s']:.0f}), pack "
        f"{cal.pack_pairs_per_s:.0f} pairs/s ({c0['pack_pairs_per_s']:.0f}), "
        f"link measured {cal.link_measured}: {cal.link_bytes_per_s:.0f} B/s "
        f"latency {cal.latency_s * 1e3:.4f} ms (routing.LINK_BYTES_PER_S "
        f"{routing.LINK_BYTES_PER_S:.0f}, LATENCY_S {routing.LATENCY_S})")
    log(f"[8b routing] the load in a fresh process (library built): dlopen "
        f"{load['dlopen_s']:.4f} s, first CUDA context "
        f"{load['context_s']:.4f} s, first cuda scoring call "
        f"{load['first_s']:.4f} s against a second {load['second_s']:.4f} "
        f"s: cold cost {load['cold_s']:.4f} s (routing.LOAD_COLD_S "
        f"{routing.LOAD_COLD_S})")


def _hybrid_reference(g):
    """The hybrid program of one graph by hand: the weights of
    ``compute_cn_hybrid`` at downsample 1, solved by the numpy engine;
    returns the sequence edges' CN, or None without balance nodes."""
    from coral_tpu_torch.graph import cn_solver

    ncov_sr, ncov_lr, min_aln = 30.0, 20.0, 30
    seq, conc, disc, src = (g.sequence_edges, g.concordant_edges,
                            g.discordant_edges, g.source_edges)
    wcn = [ncov_sr * e.size / SR_LENGTH + 0.5 * ncov_lr * e.size
           for e in seq]
    wcn += [ncov_sr * (SR_LENGTH - 1.0) / SR_LENGTH + ncov_lr] * len(conc)
    wcn += [ncov_sr * (SR_LENGTH - 2 * min_aln) / SR_LENGTH
            + ncov_lr] * len(disc)
    wcn += [ncov_sr * (SR_LENGTH - 2 * min_aln) / SR_LENGTH] * len(src)
    wlncn = [e.sr_count - 0.5 for e in seq]
    wlncn += [e.sr_count + e.lr_count for e in conc + disc]
    wlncn += [max(e.lr_cn, 0.1) for e in src]
    wlrseg = [0.5 * e.lr_nc ** 2 / (ncov_lr * e.size) for e in seq]
    wlrseg += [0.0] * (len(conc) + len(disc) + len(src))
    g.del_discordant_endnodes()
    A = cn_solver._balance_matrix(g, len(wcn))
    if A is None:
        return None
    x = cn_solver.solve_cn_balance(wlrseg, wcn, wlncn, A, engine="numpy",
                                   device="cpu")
    return [float(v * 2) for v in x[:len(seq)]]


def phase_hybrid_cn(scoring) -> None:
    """8c: ``compute_cn_hybrid`` on the WGS sample's 10 graphs (before CN)
    with seeded short-read counts, every ``"%f" % (2x)`` of the sequence
    edges equal to the program solved here by the numpy engine."""
    from coral_tpu_torch.graph.cn_solver import compute_cn_hybrid

    n_eq = 0
    for gi, g in enumerate(scoring["before_cn"]):
        rng = np.random.default_rng(900 + gi)
        g = copy.deepcopy(g)
        for e in g.sequence_edges:
            e.sr_count = int(rng.integers(0, max(e.lr_nc, 1) // 3000 + 2))
            e.sr_flag = "f"
        for e in g.concordant_edges + g.discordant_edges:
            e.sr_count = int(e.lr_count + rng.integers(0, 20))
            e.sr_flag = "f"
        g_ref = copy.deepcopy(g)
        compute_cn_hybrid(g, 30.0, SR_LENGTH, 20.0)
        want = _hybrid_reference(g_ref)
        require(want is not None, f"graph {gi}: no balance nodes")
        got = [e.cn for e in g.sequence_edges]
        require(["%f" % v for v in got] == ["%f" % v for v in want],
                f"graph {gi}: compute_cn_hybrid != the numpy program")
        n_eq += len(got)
    log(f"[8c hybrid cn] compute_cn_hybrid on {len(scoring['before_cn'])} "
        f"graphs, {n_eq} sequence edges: every \"%f\" % (2x) digit of the "
        "numpy engine's solve of the same program")



# -- phase 9 --------------------------------------------------------------

E2E_JUNCTIONS = 5000      # bench_e2e's default sample
STRESS_CHROMS = 4
STRESS_READ_LEN = 1500


def phase_tools(work: str) -> dict:
    """9: the port's tools (``coral_tpu_torch/tools``) on the card, each
    through its own entry (``bench_wgs`` ran in 4a): ``bench_kernels`` at
    its three shapes (K3, K8, K9), every row agreeing; ``bench_v3_ab`` at
    2^21 pairs (K6, K2, K1), v2 and v3 support identical and the hit sum
    K1's and numpy's; ``bench_e2e`` at its default size with the ``cuda``
    engine (K1), graph and cycles files equal to a ``numpy`` run's
    (``--cn_engine numpy``); ``stress_scan`` at 4 chromosomes of 1.5 kb
    reads, host code, every record built scanned.  Each tool's launches
    are counted from zero; returns their sum."""
    import torch

    from coral_tpu_torch.ops import kernels
    from coral_tpu_torch.ops.scoring import pair_predicate_packed3_np

    launches = dict.fromkeys(kernels.LAUNCHES, 0)

    def counted(tool, expect, fn):
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = dict(kernels.LAUNCHES)
        for k in expect:
            require(got[k] > 0, f"{tool}: {k} never launched: {got}")
        for k, v in got.items():
            launches[k] += v
        log(f"[9 tools] {tool}: launches "
            f"{ {k: v for k, v in got.items() if v} }")
        return out

    rows = counted("bench_kernels", ("pair6", "bin_overlap", "match_matrix"),
                   lambda: list(bench_kernels.run("cuda")))
    for row in rows:
        log(json.dumps(row))
    require(all(r["agree"] for r in rows[1:]) and len(rows) == 7,
            f"bench_kernels: {rows}")
    log("[9 tools] bench_kernels: 6 rows, every engine agrees")

    ab = counted("bench_v3_ab", ("pair2_support", "pair3_support", "pair3"),
                 lambda: bench_v3_ab.run(N_PAIRS, engine="cuda",
                                         device="cuda"))
    log(json.dumps(ab))
    v3 = _bench_inputs()[0]
    hit_np = int(pair_predicate_packed3_np(*v3, CUTOFF, GAP)[0].sum())
    hit_k1 = int(kernels.pair3_hitmask(
        *(torch.from_numpy(c).cuda() for c in v3), CUTOFF, GAP).sum())
    require(ab["support_identical"], "bench_v3_ab: v2 and v3 support differ")
    require(ab["hitmask_sum"] == hit_k1 == hit_np,
            f"bench_v3_ab hits {ab['hitmask_sum']}, K1 {hit_k1}, numpy "
            f"{hit_np}")
    log(f"[9 tools] bench_v3_ab: support identical, {hit_k1} hits == K1's "
        "and numpy's on the same pairs")

    reports = {}
    for engine, cn_engine in (("cuda", "auto"), ("numpy", "numpy")):
        out = os.path.join(work, f"e2e_{engine}")
        reports[engine] = counted(
            f"bench_e2e --engine {engine}",
            ("pair3",) if engine == "cuda" else (),
            lambda: bench_e2e.run(out, E2E_JUNCTIONS, engine, cn_engine,
                                  device="cuda"))
        log(json.dumps({"tool": "bench_e2e", "engine": engine,
                        "cn_engine": cn_engine, **reports[engine]}))
    n_files = _same_files(os.path.join(work, "e2e_cuda"), "bench",
                          os.path.join(work, "e2e_numpy"), "bench",
                          ("graph", "cycles"))
    require(reports["cuda"]["n_breakpoints"]
            == reports["numpy"]["n_breakpoints"], "bench_e2e breakpoints")
    log(f"[9 tools] bench_e2e: {n_files} graph and cycles files identical, "
        "--engine cuda and --engine numpy --cn_engine numpy")

    stress = counted("stress_scan", (), lambda: stress_scan.run(
        os.path.join(work, "stress"), STRESS_CHROMS, STRESS_READ_LEN,
        log=lambda line: log(f"[9 stress_scan] {line}")))
    log(json.dumps({"tool": "stress_scan", **stress}))
    require(stress["records"] == stress["records_built"] > 0,
            "stress_scan: records scanned != built")
    require(not any(kernels.LAUNCHES.values()),
            "stress_scan launched a kernel")
    log(f"[9 tools] stress_scan: {stress['records']} records scanned == "
        "built")
    log(f"[9 tools] launches in this phase: {launches}")
    return launches


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
        phase_cn_batch(rec, scoring, work)
        phase_fused_step(rec, scoring)
        launches_par = phase_parallel(rec, scoring, work)
        launches_pipe = phase_pipelined(rec, scoring)
        phase_routing(rec, scoring, work)
        phase_hybrid_cn(scoring)
        launches_tools = phase_tools(work)
        rec.bam.close()
    with tempfile.TemporaryDirectory() as work:
        launches_match = phase_cluster_path(work, report)
    with tempfile.TemporaryDirectory() as work:
        phase_cycles(work)
    with tempfile.TemporaryDirectory() as work:
        phase_user_pipeline(work)
    banned = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "coral_tpu")]
    require(not banned, f"imported: {banned}")
    # a kernel's launches are those of its own path's run; the copy
    # control's are those of the reconstruct run, whose columns it read
    counted = {"pair3": launches, "pair3_support": launches,
               "pair6": launches6, "pair6_support": launches6,
               "stream_control": launches, "pair2": launches2,
               "pair2_support": launches2, "bin_overlap": launches_bins,
               "match_matrix": launches_match, "interval_index": launches6}
    # and phase 7's sharded paths (K1, K3, the index, K8), phase 8's
    # pipelined scorer (K2) and phase 9's tools
    kern = []
    for name, (source, replaces) in KERNELS.items():
        rows = report[name]
        last = rows[-1]
        err = max([r["max_abs_err"] for r in rows] + [wgs_errs.get(name, 0)])
        kern.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": counted[name][name] + launches_par[name]
                     + launches_pipe[name] + launches_tools[name],
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
