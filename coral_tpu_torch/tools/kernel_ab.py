#!/usr/bin/env python3
"""A/B of K2, K3, K4, K6, K8 and the interval index against other
checkouts, on one GPU.

    python3 coral_tpu_torch/tools/kernel_ab.py DIR[,DIR...]
        [--only NAME[,NAME...]] [--json PATH]

Each DIR is another checkout of the repository (for example the parent
commit, unpacked with ``git archive <commit> | tar -x -C build/parent``).
The kernels of every DIR and of this checkout run the same inputs, each
checkout in processes of its own, in the order DIRs, this, this, DIRs
reversed, so that every checkout is measured twice and drift shows.
``--only`` keeps some wrappers: ``pair6`` (K3), ``pair6_support`` (K4),
``interval_index`` (the build of the index K3 and K4 look sides up in,
at their long-list shapes; a checkout without it has no such rows),
``pair6_routes`` (K3 by each of its routes, the scan and the index, at
16 to 512 intervals of dense pairs, where the wrapper switches between
them; a checkout without the index has no such rows),
``bin_overlap`` (K8), ``pair3_support`` (K2, with K1 and the copy control
K7 timed on the same columns), ``pair2_support`` (K6, with K5) or
``breakpoints`` (the breakpoints stage of the long list:
``find_breakpoints_device(engine="cuda")`` on the WGS sample's chimeras
over its amplicon intervals and 8,190 decoys, last and first, host time
of five runs after one to warm up, each checkout's own host stages of
``reconstruct`` first, about 10 s a process; its tables must agree
across checkouts); without it every one runs.  K2 and K6 run on the WGS sample's own pairs (the
junction-heavy sample's adjacent pairs over its 10 amplicon intervals,
through the host stages of ``reconstruct``), on ``chip_smoke``'s dense
cases at 2^21 pairs and 16 intervals, on pairs in BAM order and pairs
whose hits all fall on one interval, and at 256, 512, 2,048 and 8,190
intervals (either side of their grid's switch at 256); the summary gives
K2 / K1, K2 / K7 and K6 / K5 per checkout, and the kernels and memsets
the profiler saw in one call of each.

Every call is held against its plain version first, then timed four ways:

- ``ms``: median CUDA-event time of one call after an L2 flush
  (:func:`coral_tpu_torch.tools.bench_common.cuda_ms`, the timer of
  ``chip_smoke.py`` and the other tools);
- ``ms_wait``: the same with the card idle for about 0.1 ms after the
  flush (``cuda_ms(..., wait=True)``), so that the host has queued the
  whole call before the first event (the card's time alone);
- ``device_us``: the profiler's device time of every kernel and memset
  the call launches (None where the profiler sees no device time; the
  names and µs of each are kept as ``launches``);
- ``host_us``: wall time a call of 200 calls back to back, ending in a
  synchronise: what a path that calls the wrapper in a loop pays, host
  launch cost included.

Prints one line per case and kernel; ``--json`` writes every number to
PATH.  Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HOST_CALLS = 200
WRAPPERS = ("pair6", "pair6_support", "interval_index", "pair6_routes",
            "bin_overlap", "pair3_support", "pair2_support", "breakpoints")
ROUTE_SHAPES = (16, 32, 64, 128, 256, 512)
STAGE_RUNS = 5
# (label, numerator, denominator): kernels read against their sticks
RATIOS = (("K4/K3", "pair6_support", "pair6"),
          ("K2/K1", "pair3_support", "pair3"),
          ("K2/K7", "pair3_support", "stream_control"),
          ("K6/K5", "pair2_support", "pair2"))


# the shapes of chip_smoke's phases 4b and 4d without the sample
N_DECOYS = 8190
N_AMPLICONS = 10
CHR_LEN = 159_345_973     # the sample's chromosomes (bench_wgs.CHR_LEN)


def wgs_like_reads():
    """One chromosome's 517,992 reads of 1.5 kb, spread evenly and sorted
    by start (the sample's own first chromosome holds half of its reads in
    the amplicon's 4 bins of 100 kb)."""
    rng = np.random.default_rng(3)
    ws = np.sort(rng.integers(0, CHR_LEN - 1500, 517_992)).astype(np.int32)
    return ws, ws + 1500


def wgs_like_case6(decoys_first: bool, n: int = 1_500_000, seed: int = 23):
    """``n`` pairs, every one a hit on one of 10 amplicon intervals (on
    chromosome codes 0-9, pairs of one amplicon together, as the sample's
    BAM order puts them), and 8,190 decoy intervals that no side overlaps
    (codes 10-21, and code 0 past the chromosome's end), after or before
    the real ones.  Returns ((int_chrom, int_start, int_end), packed
    columns)."""
    rng = np.random.default_rng(seed)
    amp = np.repeat(np.arange(N_AMPLICONS), -(-n // N_AMPLICONS))[:n]
    ic = np.arange(N_AMPLICONS, dtype=np.int64)
    is_ = np.full(N_AMPLICONS, 55_000_000, np.int64)
    ie = is_ + 400_000
    k = np.arange(N_DECOYS)
    dc = np.where(k < N_DECOYS // 2, 10 + k % 12, 0)
    ds = np.where(k < N_DECOYS // 2, 1_000_000 + 2_000 * k,
                  CHR_LEN + 1_000 + 2_000 * k)
    if decoys_first:
        ic, is_, ie = (np.concatenate(p) for p in
                       ((dc, ic), (ds, is_), (ds + 1_000, ie)))
    else:
        ic, is_, ie = (np.concatenate(p) for p in
                       ((ic, dc), (is_, ds), (ie, ds + 1_000)))
    lo_i = 55_000_000 + rng.integers(0, 390_000, n)
    lo_j = 55_000_000 + rng.integers(0, 390_000, n)
    # opposite strands: a hit whatever the reference jump; side j '-' is
    # stored r1 > r2
    side_i = ((amp + 1) << 9) | (60 << 1) | 1
    side_j = ((amp + 1) << 9) | (60 << 1)
    cols = [rng.integers(0, 50, n), lo_i, lo_i + 1_000, lo_j + 1_000, lo_j,
            (side_i << 14) | side_j]
    return ((ic.astype(np.int32), is_.astype(np.int32), ie.astype(np.int32)),
            [c.astype(np.int32) for c in cols])


def device_us(fn, reps: int = 20):
    """Device µs a call of every kernel and memset ``fn`` launches
    ({name: µs}), or None where the profiler sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = prof.key_averages()
    except Exception:   # no device trace on this machine
        return None
    out = {}
    for r in rows:
        t = getattr(r, "device_time_total", None)
        if t is None:
            t = getattr(r, "cuda_time_total", 0)
        if t:
            out[r.key[:48]] = round(t / reps, 2)
    return out or None


def host_us(fn) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / HOST_CALLS * 1e6


def wgs_pairs(cs, bam_path, cns, seeds):
    """The sample's adjacent pairs over its amplicon intervals, packed v3
    and v2 as chip_smoke's phases 4a and 4c pack them: (v3 columns, v2
    columns, number of intervals).  Runs the host stages of reconstruct up
    to the interval search, on the CPU."""
    from coral_tpu_torch.config import DEFAULT_CONFIG
    from coral_tpu_torch.io.bam import BamFile
    from coral_tpu_torch.native.bamcore import pack_pairs2
    from coral_tpu_torch.ops.pairs import adjacent_pair_indices, \
        build_chimera_table
    from coral_tpu_torch.ops.scoring import pack_pairs3_host
    from coral_tpu_torch.reconstruct import Reconstruction

    rec = Reconstruction(BamFile(bam_path), seeds, DEFAULT_CONFIG,
                         device="cpu")
    rec.read_cns(cns)
    rec.collect()
    rec.hash_to_segments()
    rec.find_amplicon_intervals()
    rec.bam.close()
    t = build_chimera_table(rec.chimeras)
    pi, _ = adjacent_pair_indices(t.read_off)
    ic, is_, ie = cs._interval_arrays(rec.amplicon_intervals)
    aln = (pi, t.q_start, t.q_end, t.r1, t.r2, t.chrom, t.strand, t.mapq)
    return (pack_pairs3_host(*aln, ic, is_, ie, min_mapq=cs.MIN_MAPQ),
            pack_pairs2(*aln, ic, is_, ie), len(ic))


def support_cases(cs, kernels, wgs, only):
    """(case, kernel, call, plain) of K2 with K1 and K7, and of K6 with K5,
    on the same columns (``wgs``: :func:`wgs_pairs`)."""
    import torch

    p3, p2, n_wgs = wgs
    n, n_int = cs.N_PAIRS, cs.N_INT
    shapes = [("WGS sample", p3, p2, n_wgs),
              ("dense, 2^21 pairs, 16 intervals",
               cs.dense_case(n, n_int, seed=7), cs.dense_case2(n, n_int,
                                                               seed=17),
               n_int)]
    for case, p in (
            ("BAM order, 2^21 pairs, 16 intervals",
             cs.ordered_case2(n, n_int, "BAM order", seed=29)),
            ("one interval, 2^21 pairs, 16 intervals",
             cs.ordered_case2(n, n_int, "one interval", seed=31)),
            ("dense, 2^21 pairs, 8190 intervals",
             cs.dense_case2(n, cs.N_SUPPORT_BINS, seed=37))):
        n_i = cs.N_SUPPORT_BINS if "8190" in case else n_int
        shapes.append((case, cs.v2_to_v3(p, cs.MIN_MAPQ), p, n_i))
    # either side of the grid's switch to fewer blocks at wide tables
    # (csrc/pair_common.cuh, kWideBins)
    for n_i in (256, 512, 2048):
        p = cs.dense_case2(n, n_i, seed=n_i)
        shapes.append((f"dense, 2^21 pairs, {n_i} intervals",
                       cs.v2_to_v3(p, cs.MIN_MAPQ), p, n_i))
    g, c, q = cs.GAP, cs.CUTOFF, cs.MIN_MAPQ
    out = []
    for case, p3, p2, n_i in shapes:
        c3 = [torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in p3]
        c2 = [torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in p2]
        if "pair3_support" in only:
            out += [
                (case, "pair3_support",
                 lambda a=c3, k=n_i: kernels.pair3_support(*a, k, c, g),
                 lambda a=c3, k=n_i: kernels.pair3_support_torch(*a, k, c,
                                                                  g)),
                (case, "pair3", lambda a=c3: kernels.pair3_hitmask(*a, c, g),
                 lambda a=c3: kernels.pair3_hitmask_torch(*a, c, g)),
                (case, "stream_control",
                 lambda a=c3: kernels.stream_control(*a),
                 lambda a=c3: kernels.stream_control_torch(*a))]
        if "pair2_support" in only:
            out += [
                (case, "pair2_support",
                 lambda a=c2, k=n_i: kernels.pair2_support(*a, k, c, q, g),
                 lambda a=c2, k=n_i: kernels.pair2_support_torch(*a, k, c,
                                                                  q, g)),
                (case, "pair2",
                 lambda a=c2: kernels.pair2_hitmask(*a, c, q, g),
                 lambda a=c2: kernels.pair2_hitmask_torch(*a, c, q, g))]
    return out


def cases(cs, kernels, sample_reads, wgs, only):
    """(case, kernel, call, plain) at the shapes PERF.md lists for K2, K3,
    K4, K6 and K8, made here for any checkout's kernels (``cs``:
    chip_smoke); ``sample_reads`` is (starts, ends) of the WGS sample's
    first chromosome, the shape of chip_smoke's phase 4d, and ``wgs`` the
    sample's packed pairs (:func:`wgs_pairs`)."""
    import torch

    from coral_tpu_torch.ops.scoring import state_from_numpy

    out = []
    kw = dict(cutoff=cs.CUTOFF, min_mapq=cs.MIN_MAPQ, gap_=cs.GAP)
    try:
        from coral_tpu_torch.ops.interval_index import (
            build_interval_index, build_interval_index_torch)
    except ImportError:       # a checkout from before the index
        build_interval_index = None
    if only & {"pair6", "pair6_support", "interval_index"}:
        _, bench6, _ = cs._bench_inputs()
        for case, (ints, packed) in (
                ("bench, 16 intervals", bench6),
                ("dense, 16 intervals",
                 cs.dense_case6(cs.N_PAIRS, cs.N_INT, seed=11)),
                ("dense, 8200 intervals",
                 cs.dense_case6(cs.N_PAIRS, cs.N_INT_LONG, seed=13)),
                ("hot bins, colliding cache slots",
                 cs.dense_case6(cs.N_PAIRS, cs.N_INT_LONG, seed=19,
                                hot=cs.HOT_WINDOWS)),
                ("WGS-like, decoys last", wgs_like_case6(False)),
                ("WGS-like, decoys first", wgs_like_case6(True))):
            st = state_from_numpy(*ints, packed, device="cuda")
            a = (st.int_chrom, st.int_start, st.int_end, *st.packed)
            for name, fn in (("pair6", "pair6_hitmask"),
                             ("pair6_support", "pair6_support")):
                if name in only:
                    kern = getattr(kernels, fn)
                    plain = getattr(kernels, fn + "_torch")
                    out.append((case, name,
                                lambda a=a, f=kern: f(*a, **kw),
                                lambda a=a, f=plain: f(*a, **kw)))
            if "interval_index" in only and build_interval_index \
                    and "16" not in case:
                out.append((case, "interval_index",
                            lambda a=a: build_interval_index(*a[:3], "cuda"),
                            lambda a=a: build_interval_index_torch(*a[:3])))
    if "pair6_routes" in only and build_interval_index:
        for n_i in ROUTE_SHAPES:
            ints, packed = cs.dense_case6(cs.N_PAIRS, n_i, seed=n_i)
            st = state_from_numpy(*ints, packed, device="cuda")
            a = (st.int_chrom, st.int_start, st.int_end, *st.packed)
            for route, threshold in (("scan", 1 << 30), ("index", 0)):
                out.append((f"dense, {n_i} intervals, by the {route}",
                             "pair6",
                             lambda a=a, t=threshold: _routed(kernels, t, a,
                                                              kw),
                             lambda a=a: kernels.pair6_hitmask_torch(*a,
                                                                     **kw)))
    if "bin_overlap" in only:
        starts, ends = cs.synth_reads(cs.N_READS)
        order = np.argsort(starts, kind="stable")
        span = cs.READ_SPAN
        shapes = [
            ("2^21 reads, 256 bins", starts, ends, span // 256, 256),
            ("2^21 reads, 65536 bins", starts, ends, span // 65536, 65536),
            ("2^21 sorted reads, 256 bins", starts[order], ends[order],
             span // 256, 256),
            ("2^21 sorted reads, 65536 bins", starts[order], ends[order],
             span // 65536, 65536),
            ("WGS-like chromosome, 1594 bins", *wgs_like_reads(), 100_000,
             -(-CHR_LEN // 100_000))]
        for bin_size in (100_000, 10_000, 1_000, 100):
            n_bins = -(-CHR_LEN // bin_size)
            shapes.append((f"WGS sample, chr1, {n_bins} bins of {bin_size}",
                           *sample_reads, bin_size, n_bins))
        for case, s, e, bin_size, n_bins in shapes:
            a = (torch.from_numpy(s).cuda(), torch.from_numpy(e).cuda(), 0,
                 bin_size, n_bins)
            out.append((case, "bin_overlap",
                        lambda a=a: kernels.bin_overlap(*a),
                        lambda a=a: kernels.bin_overlap_torch(*a)))
    if only & {"pair3_support", "pair2_support"}:
        out += support_cases(cs, kernels, wgs, only)
    return out


def _routed(kernels, threshold: int, args, kw):
    """K3 with the switch between its routes set to ``threshold``."""
    keep = kernels.PAIR6_SCAN_MAX_INTERVALS
    kernels.PAIR6_SCAN_MAX_INTERVALS = threshold
    try:
        return kernels.pair6_hitmask(*args, **kw)
    finally:
        kernels.PAIR6_SCAN_MAX_INTERVALS = keep


def _tensors(out) -> tuple:
    """A wrapper's result as a tuple of tensors (an index: its own)."""
    if hasattr(out, "lev"):
        return out.skey, out.ekey, out.lev
    return out if isinstance(out, tuple) else (out,)


def breakpoint_stage(cs, bam_path: str, cns: str, seeds: str):
    """Rows of the breakpoints stage on the long list (``--only
    breakpoints``): host seconds of :data:`STAGE_RUNS` runs of
    ``find_breakpoints_device(engine="cuda")`` and a digest of its
    table, with the decoys last and first."""
    import hashlib

    import torch

    from coral_tpu_torch.config import DEFAULT_CONFIG
    from coral_tpu_torch.io.bam import BamFile
    from coral_tpu_torch.ops.pairs import find_breakpoints_device
    from coral_tpu_torch.reconstruct import Reconstruction

    rec = Reconstruction(BamFile(bam_path), seeds, DEFAULT_CONFIG,
                         device="cpu")
    rec.read_cns(cns)
    rec.collect()
    rec.hash_to_segments()
    rec.find_amplicon_intervals()
    rec.bam.close()
    bp = DEFAULT_CONFIG.bp
    real = [list(iv) for iv in rec.amplicon_intervals]
    decoys = cs.decoy_intervals(N_DECOYS)
    rows = []
    for case, intervals in (("WGS sample, decoys last", real + decoys),
                            ("WGS sample, decoys first", decoys + real)):
        secs = []
        for k in range(STAGE_RUNS + 1):
            t0 = time.perf_counter()
            tb = find_breakpoints_device(
                rec.chimeras, intervals, bp.min_bp_match_cutoff,
                bp.min_mapq, 100, bp.gap_mapq, None, engine="cuda",
                as_table=True, device="cuda")
            torch.cuda.synchronize()
            if k:
                secs.append(time.perf_counter() - t0)
        digest = hashlib.sha256()
        for c in ("c1", "p1", "s1", "c2", "p2", "s2", "ridx", "ti", "tj",
                  "rgap", "flip", "q1", "q2"):
            digest.update(np.ascontiguousarray(getattr(tb, c)).tobytes())
        rows.append(dict(case=case, kernel="breakpoints", seconds=secs,
                         rows=len(tb), digest=digest.hexdigest()[:16]))
    return rows


def child(root: str, sample: str, only: set) -> None:
    """The kernels of the checkout at ``root`` on :func:`cases`; one JSON
    line."""
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs   # this checkout's inputs
    from coral_tpu_torch.tools.bench_common import cuda_ms

    # the package comes anew from ``root``: chip_smoke imported this
    # checkout's
    for name in [m for m in sys.modules
                 if m.split(".")[0] == "coral_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, os.path.abspath(root))
    from coral_tpu_torch.ops import kernels

    cs.require(os.path.dirname(kernels.__file__).startswith(
        os.path.abspath(root)), f"kernels not from {root}")
    with np.load(sample) as z:
        sample_reads = z["starts"], z["ends"]
        wgs = ([z[f"v3_{k}"] for k in range(3)],
               [z[f"v2_{k}"] for k in range(4)], int(z["n_int"]))
        inputs = [str(z[k]) for k in ("bam", "cns", "seeds")]
    rows = breakpoint_stage(cs, *inputs) if "breakpoints" in only else []
    for case, name, call, plain in cases(cs, kernels, sample_reads, wgs,
                                         only):
        got, want = (_tensors(x) for x in (call(), plain()))
        torch.cuda.synchronize()
        cs.require(all(torch.equal(g, w) for g, w in zip(got, want)),
                   f"{root}: {name} != plain ({case})")
        dev = device_us(call)
        rows.append(dict(case=case, kernel=name,
                         ms=cuda_ms(call),
                         ms_wait=cuda_ms(call, wait=True),
                         device_us=None if dev is None else round(
                             sum(dev.values()), 2),
                         host_us=host_us(call), launches=dev))
    print(json.dumps({"root": root, "rows": rows}), flush=True)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if argv[:1] == ["--child"]:
        child(argv[1], argv[2], set(argv[3].split(",")))
        return 0
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    only = argv[argv.index("--only") + 1] if "--only" in argv else \
        ",".join(WRAPPERS)
    unknown = set(only.split(",")) - set(WRAPPERS)
    if unknown:
        print(f"--only: unknown {sorted(unknown)}; one or more of "
              f"{', '.join(WRAPPERS)}", file=sys.stderr)
        return 2
    out_json = argv[argv.index("--json") + 1] if "--json" in argv else None
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from coral_tpu_torch.io.bam import BamFile
    from coral_tpu_torch.tools.bench_wgs import build_junction_heavy

    roots = argv[0].split(",") + [ROOT]
    order = roots + [ROOT] + roots[-2::-1]
    runs = {}
    with tempfile.TemporaryDirectory() as work:
        bam_path, cns, seeds, _ = build_junction_heavy(work)
        bam = BamFile(bam_path)
        first = bam.ref_id == 0
        sample = os.path.join(work, "sample.npz")
        p3, p2, n_int = wgs_pairs(cs, bam_path, cns, seeds)
        np.savez(sample, starts=bam.pos[first].astype(np.int32),
                 ends=bam.end[first].astype(np.int32), n_int=n_int,
                 bam=bam_path, cns=cns, seeds=seeds,
                 **{f"v3_{k}": c for k, c in enumerate(p3)},
                 **{f"v2_{k}": c for k, c in enumerate(p2)})
        bam.close()
        for root in order:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", root,
                 sample, only], capture_output=True, text=True, timeout=900)
            if out.returncode:
                print(out.stdout[-3000:] + out.stderr[-3000:], flush=True)
                return out.returncode
            runs.setdefault(root, []).append(
                json.loads(out.stdout.strip().splitlines()[-1])["rows"])
    names = [os.path.basename(r.rstrip("/")) if r != ROOT else "this"
             for r in roots]
    gpu = cs.nvidia_smi()
    print(f"gpu: {gpu}")
    print(f"checkouts: {', '.join(names)}; per checkout its two runs")
    # rows by (case, kernel): a checkout may lack some (the index)
    keyed = {r: [{(x["case"], x["kernel"]): x for x in run}
                 for run in runs[r]] for r in roots}
    order_of = list(dict.fromkeys((x["case"], x["kernel"])
                                  for r in roots for x in runs[r][0]))
    for key in order_of:
        print(f"{key[0]} | {key[1]}")
        base = None
        for n, r in zip(names, roots):
            if key not in keyed[r][0]:
                print(f"    {n}: none")
                continue
            a, b = (x[key] for x in keyed[r])
            if key[1] == "breakpoints":
                secs = a["seconds"] + b["seconds"]
                print(f"    {n}: s {' '.join(f'{t:.4f}' for t in secs)} | "
                      f"median {np.median(secs):.4f} min {min(secs):.4f} "
                      f"max {max(secs):.4f} | rows {a['rows']} digest "
                      f"{a['digest']} {b['digest']}")
                continue
            mean = (a["ms"] + b["ms"]) / 2
            base = base or mean
            print(f"    {n}: ms {a['ms']:.4f} {b['ms']:.4f} | ms_wait "
                  f"{a['ms_wait']:.4f} {b['ms_wait']:.4f} | device_us "
                  f"{a['device_us']} {b['device_us']} | host_us "
                  f"{a['host_us']:.2f} {b['host_us']:.2f} | ms / "
                  f"{names[0]} {mean / base:.3f}")
    digests = {x["digest"] for r in roots for run in runs[r] for x in run
               if x["kernel"] == "breakpoints"}
    if len(digests) > 1:
        print(f"breakpoint tables differ between runs: {sorted(digests)}")
        return 1
    for case in dict.fromkeys(row["case"] for row in runs[roots[0]][0]):
        ratio = []
        for n, r in zip(names, roots):
            ms = {}
            for x in runs[r]:
                for row in x:
                    if row["case"] == case and "ms" in row:
                        ms[row["kernel"]] = ms.get(row["kernel"], 0) \
                            + row["ms"]
            parts = [f"{label} {ms[a] / ms[b]:.3f}"
                     for label, a, b in RATIOS if a in ms and b in ms]
            if parts:
                ratio.append(f"{n}: {' '.join(parts)}")
        if ratio:
            print(f"{case}: {'; '.join(ratio)}")
    for n, r in zip(names, roots):
        for row in runs[r][0]:
            if row["kernel"] in ("pair3_support", "pair2_support",
                                 "pair6_support", "pair6", "pair3"):
                print(f"profiler, {n}, {row['kernel']}, {row['case']}: "
                      f"{row['launches']}")
    if out_json:
        with open(out_json, "w") as fh:
            json.dump({"gpu": gpu, **{r: runs[r] for r in roots}}, fh)
    # again at the end, where a cut log keeps it
    print(f"gpu: {gpu}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
