#!/usr/bin/env python3
"""Side-by-side timings of the plain PyTorch versions and the CUDA kernels
of the three hot loops (the port's counterpart of
``tools/bench_kernels.py``), at the JAX tool's shapes:

- the junction predicate over the 6-column layout, 2^21 pairs and 16
  intervals: ``torch`` (the predicate on the 14 unpacked columns) against
  ``cuda`` (K3, ``kernels.pair6_hitmask``);
- aligned bases per genome bin, 2^21 reads into 256 bins: ``torch`` (the
  int64 prefix tables, built once, evaluated at the bin edges) against
  ``cuda`` (K8, ``kernels.bin_overlap``);
- the breakpoint match matrix at n = 2,048: ``torch`` (the broadcast
  compare, ``kernels.match_matrix_torch``) against ``cuda`` (K9,
  ``kernels.match_matrix``).

    python -m coral_tpu_torch.tools.bench_kernels [--device cuda|cpu]

The first line names the device; then one JSON line per (kernel, engine,
shape): ``kernel``, ``engine``, ``n``, ``bins`` (coverage),
``ms``, ``items_per_s`` or ``pairs_per_s``, and ``agree``: the engine's
result equals a numpy reference on the same inputs (for the coverage
bins, every read clipped to each bin it touches and the overlaps summed,
:func:`bin_overlap_np`, which shares no code with either engine).  On the
card ``ms`` is the median
CUDA-event time of one call after an L2 flush
(:func:`bench_common.cuda_ms`); with ``--device cpu`` only the ``torch``
engine runs and ``ms`` is host time.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

CUTOFF, MIN_MAPQ, GAP = 100, 20, 100.0
MATCH_CUTOFF = 2000
ENGINES = ("torch", "cuda")
# pair_predicate's 14 unpacked columns (the NM pair zero: the gate is off)
PAIR_ORDER = ("qi_end", "qj_start", "chrom_i", "r1_i", "r2_i", "strand_i",
              "mapq_i", "nm_i", "chrom_j", "r1_j", "r2_j", "strand_j",
              "mapq_j", "nm_j")


def _engines(engines, dev):
    for e in engines:
        if e not in ENGINES:
            raise ValueError(f"unknown engine {e!r} (torch or cuda)")
        if e == "cuda" and dev.type != "cuda":
            raise ValueError(f"engine 'cuda' needs a CUDA device, not {dev}")
    return engines


def _rows(kernel, calls, engines, dev, agree, extra, per_call):
    """One row per engine: its result checked by ``agree``, its time."""
    from .bench_common import time_ms

    rows = []
    for name in engines:
        ok = bool(agree(calls[name]()))
        t = time_ms(calls[name], dev) / 1e3
        key, items = per_call
        rows.append({"kernel": kernel, "engine": name, **extra,
                     "ms": round(t * 1e3, 4), key: round(items / t),
                     "agree": ok})
    return rows


def pair_predicate_case(n_pairs, n_intervals=16, *, device="cuda"):
    """The 6-column junction predicate's case (the JAX tool's inputs, seed
    0): ``(cols, intervals, calls)``, the 12 int32 pair columns by name,
    ``(ic, is_, ie)`` and each engine's call on ``device``, which returns
    ``(hit, io)``."""
    import torch

    from ..device import resolve_device
    from ..ops import kernels
    from ..ops.scoring import pack_pair_cols, pair_predicate

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    cols = {
        "qi_end": rng.integers(0, 30_000, n_pairs).astype(np.int32),
        "qj_start": rng.integers(0, 30_000, n_pairs).astype(np.int32),
        "chrom_i": rng.integers(0, 24, n_pairs).astype(np.int32),
        "r1_i": rng.integers(0, 2_000_000_00, n_pairs).astype(np.int32),
        "r2_i": rng.integers(0, 2_000_000_00, n_pairs).astype(np.int32),
        "strand_i": rng.choice([-1, 1], n_pairs).astype(np.int32),
        "mapq_i": rng.integers(0, 61, n_pairs).astype(np.int32),
        "chrom_j": rng.integers(0, 24, n_pairs).astype(np.int32),
        "r1_j": rng.integers(0, 2_000_000_00, n_pairs).astype(np.int32),
        "r2_j": rng.integers(0, 2_000_000_00, n_pairs).astype(np.int32),
        "strand_j": rng.choice([-1, 1], n_pairs).astype(np.int32),
        "mapq_j": rng.integers(0, 61, n_pairs).astype(np.int32),
    }
    ic = (np.arange(n_intervals) % 24).astype(np.int32)
    is_ = (np.arange(n_intervals) * 3_000_000).astype(np.int32)
    ie = is_ + 2_000_000

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    zeros = on(np.zeros(n_pairs, np.float32))
    d14 = [zeros if k.startswith("nm") else on(cols[k]) for k in PAIR_ORDER]
    dic, dis, die = on(ic), on(is_), on(ie)
    packed = [on(c) for c in pack_pair_cols(
        *(cols[k] for k in PAIR_ORDER if not k.startswith("nm")))]
    calls = {
        "torch": lambda: pair_predicate(*d14, dic, dis, die, CUTOFF,
                                        MIN_MAPQ, GAP, np.inf),
        "cuda": lambda: kernels.pair6_hitmask(
            dic, dis, die, *packed, CUTOFF, MIN_MAPQ, GAP),
    }
    return cols, (ic, is_, ie), calls


def bench_pair_predicates(n_pairs, n_intervals=16, *, engines=ENGINES,
                          device="cuda"):
    """Rows of the 6-column junction predicate (K3 and its plain
    counterpart) over ``n_pairs`` random pairs and ``n_intervals``,
    against the numpy predicate on the 14 unpacked columns."""
    from ..device import resolve_device
    from ..ops.scoring import pair_predicate_np

    dev = resolve_device(device)
    _engines(engines, dev)
    cols, ints, calls = pair_predicate_case(n_pairs, n_intervals,
                                            device=dev)
    zeros = np.zeros(n_pairs, np.float32)
    want = pair_predicate_np(
        *(zeros if k.startswith("nm") else cols[k] for k in PAIR_ORDER),
        *ints, CUTOFF, MIN_MAPQ, GAP, np.inf)

    def agree(out):
        hit, io = (t.cpu().numpy() for t in out)
        return np.array_equal(hit, want[0]) and np.array_equal(io, want[1])

    return _rows("pair_predicates", calls, engines, dev, agree,
                 {"n": n_pairs}, ("items_per_s", n_pairs))


def bin_overlap_np(starts, ends, origin: int, bin_size: int, n_bins: int):
    """Aligned bases per bin, int64 (n_bins,): every read ``[s, e)``
    clipped to each of the ``n_bins`` bins of ``bin_size`` from ``origin``
    that it touches, the overlaps summed per bin."""
    last_edge = origin + n_bins * bin_size
    s = np.clip(np.asarray(starts, np.int64), origin, last_edge)
    e = np.clip(np.asarray(ends, np.int64), origin, last_edge)
    s, e = s[e > s], e[e > s]
    first = (s - origin) // bin_size
    last = (e - 1 - origin) // bin_size
    out = np.zeros(n_bins, np.int64)
    for k in range(int((last - first).max(initial=-1)) + 1):
        b = first + k
        m = b <= last
        lo = np.maximum(s[m], origin + b[m] * bin_size)
        hi = np.minimum(e[m], origin + (b[m] + 1) * bin_size)
        np.add.at(out, b[m], hi - lo)
    return out


def coverage_case(n_reads, n_bins, *, device="cuda"):
    """The genome-bin coverage's case (the JAX tool's inputs, seed 1):
    ``(starts, ends, bin_size, calls)``, ``n_reads`` int32 reads over
    200 Mb and each engine's call on ``device``, which returns the int64
    bin sums.  The ``torch`` engine's prefix tables build once, as the
    pipeline amortizes them over its queries; a call evaluates the bin
    edges."""
    import torch

    from ..device import resolve_device
    from ..ops import kernels
    from ..ops.scoring import coverage_prefix_eval, coverage_prefix_tables

    dev = resolve_device(device)
    rng = np.random.default_rng(1)
    starts = rng.integers(0, 200_000_000, n_reads).astype(np.int32)
    ends = (starts + rng.integers(1_000, 60_000, n_reads)).astype(np.int32)
    bin_size = 200_000_000 // n_bins
    d_starts = torch.from_numpy(starts).to(dev)
    d_ends = torch.from_numpy(ends).to(dev)
    tables = coverage_prefix_tables(d_starts, d_ends)
    edges = torch.arange(n_bins + 1, dtype=torch.int64, device=dev) \
        * bin_size

    def prefix_bins():
        p = coverage_prefix_eval(tables, edges)
        return p[1:] - p[:-1]

    calls = {"torch": prefix_bins,
             "cuda": lambda: kernels.bin_overlap(d_starts, d_ends, 0,
                                                 bin_size, n_bins)}
    return starts, ends, bin_size, calls


def bench_coverage_bins(n_reads, n_bins, *, engines=ENGINES, device="cuda"):
    """Rows of the genome-bin coverage (K8 and the prefix tables) of
    ``n_reads`` random reads over 200 Mb in ``n_bins`` bins, against
    :func:`bin_overlap_np`."""
    from ..device import resolve_device

    dev = resolve_device(device)
    _engines(engines, dev)
    starts, ends, bin_size, calls = coverage_case(n_reads, n_bins,
                                                  device=dev)
    want = bin_overlap_np(starts, ends, 0, bin_size, n_bins)
    return _rows("coverage_bins", calls, engines, dev,
                 lambda out: np.array_equal(out.cpu().numpy(), want),
                 {"n": n_reads, "bins": n_bins}, ("items_per_s", n_reads))


def match_case(n, *, device="cuda"):
    """The match matrix's case (the JAX tool's inputs, seed 2):
    ``(p1, p2, calls)``, ``n`` int32 breakpoint positions on each side
    and each engine's call on ``device``, which returns the (n, n)
    matrix."""
    import torch

    from ..device import resolve_device
    from ..ops import kernels

    dev = resolve_device(device)
    rng = np.random.default_rng(2)
    p1 = rng.integers(0, 1_000_000, n).astype(np.int32)
    p2 = rng.integers(0, 1_000_000, n).astype(np.int32)
    da, db = torch.from_numpy(p1).to(dev), torch.from_numpy(p2).to(dev)
    calls = {"torch": lambda: kernels.match_matrix_torch(da, db,
                                                         MATCH_CUTOFF),
             "cuda": lambda: kernels.match_matrix(da, db, MATCH_CUTOFF)}
    return p1, p2, calls


def bench_match_matrix(n, *, engines=ENGINES, device="cuda"):
    """Rows of the (n, n) match matrix (K9 and its plain version) of
    ``n`` random breakpoint positions, against numpy's broadcast."""
    from ..device import resolve_device

    dev = resolve_device(device)
    _engines(engines, dev)
    p1, p2, calls = match_case(n, device=dev)
    a, b = p1.astype(np.int64), p2.astype(np.int64)
    want = ((np.abs(a[:, None] - a[None, :]) < MATCH_CUTOFF)
            & (np.abs(b[:, None] - b[None, :]) < MATCH_CUTOFF))
    return _rows("match_matrix", calls, engines, dev,
                 lambda out: np.array_equal(out.cpu().numpy() != 0, want),
                 {"n": n}, ("pairs_per_s", n * n))


def run(device="cuda", n_pairs=1 << 21, n_reads=1 << 21, n_bins=256,
        n_match=2048):
    """The three hot loops at the JAX tool's shapes; yields the device
    line (``platform``, ``device``, ``count``), then each row as it is
    measured.  Both engines on a card, the ``torch`` engine alone on the
    CPU."""
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        engines = ENGINES
        yield {"platform": "gpu", "device": torch.cuda.get_device_name(dev),
               "count": torch.cuda.device_count()}
    else:
        engines = ("torch",)
        yield {"platform": "cpu", "device": "cpu", "count": 1}
    yield from bench_pair_predicates(n_pairs, engines=engines, device=dev)
    yield from bench_coverage_bins(n_reads, n_bins, engines=engines,
                                   device=dev)
    yield from bench_match_matrix(n_match, engines=engines, device=dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for row in run(args.device):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
