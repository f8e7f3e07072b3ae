#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``coral_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero:

1. environment: torch/CUDA versions, the card's name and power limit,
   whether the native BAM core loaded;
2. build: the CUDA kernels of ``coral_tpu_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch version (and numpy) at the
   benchmark shape, 2^21 pairs and 16 intervals, bit for bit, with CUDA
   event timings;
4. the main path at WGS scale: the junction-heavy 10-chromosome sample of
   ``tools/bench_wgs.py`` reconstructed with the ``cuda`` engine (K1) and
   scored with the fused batch scorer (K2), held against the ``numpy``
   engine: graph files byte-identical, support and coverage exact;
5. the full pipeline with cycles on a mixed sample through
   ``python -m coral_tpu_torch reconstruct``, ``cuda`` vs ``numpy``:
   graph and cycles files byte-identical.

The last three lines are the card (``nvidia-smi``), a JSON object with
one entry per kernel, and ``{"ok": true, "device": {...}}``.  Nothing here
imports JAX.  Without a CUDA device, or outside a checkout of the
repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import filecmp
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N_PAIRS = 1 << 21
N_INT = 16
CUTOFF = 100
GAP = 100.0
SOURCE = "coral_tpu_torch/csrc/pair3.cu"


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


# -- phase 1 --------------------------------------------------------------

def phase_env() -> str:
    import torch

    log(f"[1 env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    smi = nvidia_smi()
    log(f"[1 env] nvidia-smi: {smi}")
    from coral_tpu.native import bamcore

    try:
        bamcore._load()
        log("[1 env] native BAM core: libbamcore.so loaded")
    except OSError as e:
        log(f"[1 env] native BAM core: not loaded ({e}); pure-Python "
            "scanner in use")
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

def _bench_case():
    from bench import synth_alignment_table, synth_scoring_batch
    from coral_tpu.ops.scoring import pack_pairs3_host

    _, _, cols, ic, is_, ie = synth_scoring_batch(N_PAIRS, N_INT, seed=0)
    return pack_pairs3_host(*synth_alignment_table(cols), ic, is_, ie,
                            min_mapq=20)


def dense_case(n: int, n_int: int, seed: int):
    """About half the rows hit; includes the threshold edges
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


def phase_kernels() -> list:
    import torch

    from coral_tpu.ops.scoring import pair_predicate_packed3 as np_predicate
    from coral_tpu_torch.ops import kernels
    from coral_tpu_torch.ops.scoring import state_from_numpy

    dev = torch.device("cuda")
    ic = np.arange(N_INT, dtype=np.int32)
    is_ = ic.astype(np.int64)
    report = {"pair3": [], "pair3_support": []}
    for case, packed in (("bench", _bench_case()),
                         ("dense", dense_case(N_PAIRS, N_INT, seed=7))):
        st = state_from_numpy(ic, is_, is_, packed, device=dev)
        cols = st.packed3
        hit_np, iogm_np = np_predicate(np, *packed, CUTOFF, GAP)
        sup_np = np.bincount(iogm_np[hit_np], minlength=N_INT)[:N_INT]

        hit_k = kernels.pair3_hitmask(*cols, CUTOFF, GAP)
        hit_p = kernels.pair3_hitmask_torch(*cols, CUTOFF, GAP)
        torch.cuda.synchronize()
        err1 = int((hit_k.int() - hit_p.int()).abs().max())
        require(torch.equal(hit_k, hit_p), f"K1 != plain ({case})")
        require(np.array_equal(hit_k.cpu().numpy(), hit_np),
                f"K1 != numpy ({case})")
        sup_k = kernels.pair3_support(*cols, N_INT, CUTOFF, GAP)
        sup_p = kernels.pair3_support_torch(*cols, N_INT, CUTOFF, GAP)
        torch.cuda.synchronize()
        err2 = int((sup_k.long() - sup_p.long()).abs().max())
        require(torch.equal(sup_k, sup_p), f"K2 != plain ({case})")
        require(np.array_equal(sup_k.cpu().numpy(), sup_np),
                f"K2 != numpy bincount ({case})")
        t = {
            "pair3": cuda_ms(lambda: kernels.pair3_hitmask(
                *cols, CUTOFF, GAP)),
            "pair3_plain": cuda_ms(lambda: kernels.pair3_hitmask_torch(
                *cols, CUTOFF, GAP)),
            "pair3_support": cuda_ms(lambda: kernels.pair3_support(
                *cols, N_INT, CUTOFF, GAP)),
            "pair3_support_plain": cuda_ms(lambda: kernels.pair3_support_torch(
                *cols, N_INT, CUTOFF, GAP)),
        }
        log(f"[3 kernels] {case}: n={N_PAIRS} n_int={N_INT} "
            f"hits={int(hit_np.sum())} K1==plain==numpy K2==plain==numpy; "
            f"ms K1 {t['pair3']:.4f} plain {t['pair3_plain']:.4f} | "
            f"K2 {t['pair3_support']:.4f} plain "
            f"{t['pair3_support_plain']:.4f}")
        report["pair3"].append((err1, t["pair3"], t["pair3_plain"]))
        report["pair3_support"].append(
            (err2, t["pair3_support"], t["pair3_support_plain"]))
    return report


# -- phase 4 --------------------------------------------------------------

def _staged(bam_path, cns, seeds, prefix, cfg, device):
    """reconstruct_graphs (graph files, no breakpoint-only output), stage
    by stage with the time of each."""
    import torch

    from coral_tpu.graph.breakpoint_graph import write_graph_file
    from coral_tpu.io.bam import BamFile
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


def _wgs_scoring_inputs(rec):
    """Every adjacent chimeric pair of the sample packed over the amplicon
    intervals, and every record's aligned span, on one linear genome
    coordinate (chromosome offset + position)."""
    from coral_tpu.constants import CHR_IDX
    from coral_tpu.ops.scoring import pack_pairs3_host
    from coral_tpu_torch.ops.pairs import adjacent_pair_indices, \
        build_chimera_table

    table = build_chimera_table(rec.chimeras)
    pi, _ = adjacent_pair_indices(table.read_off)
    ivs = rec.amplicon_intervals
    ic = np.asarray([CHR_IDX.get(iv[0], -2) for iv in ivs], np.int32)
    is_ = np.asarray([iv[1] for iv in ivs], np.int64)
    ie = np.asarray([iv[2] for iv in ivs], np.int64)
    packed = pack_pairs3_host(pi, table.q_start, table.q_end, table.r1,
                              table.r2, table.chrom, table.strand,
                              table.mapq, ic, is_, ie, min_mapq=20)
    span = np.int64(1) << 32
    bam = rec.bam
    code = np.asarray([CHR_IDX.get(r[0], -1) for r in bam.references],
                      np.int64)
    mapped = bam.ref_id >= 0
    base = code[bam.ref_id[mapped]] * span
    starts, ends = base + bam.pos[mapped], base + bam.end[mapped]
    return packed, (ic, is_ + ic * span, ie + ic * span), starts, ends


def phase_main_path(work: str):
    import torch

    from coral_tpu.config import DEFAULT_CONFIG
    from coral_tpu.ops.scoring import pair_predicate_packed3 as np_predicate
    from coral_tpu_torch.ops import kernels
    from coral_tpu_torch.ops.pairs import last_route_seq, route_records_since
    from coral_tpu_torch.ops.scoring import make_batch_scorer, \
        state_from_numpy
    from tools.bench_wgs import build_junction_heavy

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
    packed, (ic, is_, ie), starts, ends = _wgs_scoring_inputs(rec_c)
    t0 = time.perf_counter()
    build_tables, score = make_batch_scorer(ic, is_, ie, "cuda",
                                            device="cuda")
    support, cov = score(build_tables(starts, ends), *packed)
    support, cov = support.cpu().numpy(), cov.cpu().numpy()
    t_score = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    routes = route_records_since(seq)
    rec_c.bam.close()

    # both kernels at the main path's shape against their plain versions
    # (after the counts were read: these launches are not the main path's)
    cols = state_from_numpy(ic, is_, ie, packed, device="cuda").packed3
    hit_k = kernels.pair3_hitmask(*cols, CUTOFF, GAP)
    hit_p = kernels.pair3_hitmask_torch(*cols, CUTOFF, GAP)
    sup_k = kernels.pair3_support(*cols, len(ic), CUTOFF, GAP)
    sup_p = kernels.pair3_support_torch(*cols, len(ic), CUTOFF, GAP)
    torch.cuda.synchronize()
    errs = {"pair3": int((hit_k.int() - hit_p.int()).abs().max()),
            "pair3_support": int((sup_k.long() - sup_p.long()).abs().max())}
    require(torch.equal(hit_k, hit_p), "WGS shape: K1 != plain")
    require(torch.equal(sup_k, sup_p), "WGS shape: K2 != plain")

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
    hit, iogm = np_predicate(np, *packed, CUTOFF, GAP)
    require(np.array_equal(
        support, np.bincount(iogm[hit], minlength=len(ic))[:len(ic)]),
        "WGS support != numpy")
    s64, e64 = np.sort(starts), np.sort(ends)
    sc = np.concatenate([[0], np.cumsum(s64)])
    ec = np.concatenate([[0], np.cumsum(e64)])

    def p(x):
        ns = np.searchsorted(s64, x, side="right")
        ne = np.searchsorted(e64, x, side="right")
        return (x * ns - sc[ns]) - (x * ne - ec[ne])

    require(np.array_equal(cov, p(ie) - p(is_)), "WGS coverage != numpy")
    fmt = {k: round(v, 3) for k, v in st_c.items()}
    log(f"[4 wgs] records {n_rec} chimeric pairs {n_pairs} amplicons "
        f"{len(rec_c.graphs)} graph files identical cuda==numpy")
    log(f"[4 wgs] stages s, engine cuda: {json.dumps(fmt)}; pair scoring "
        f"{routes[0].seconds:.3f} s")
    log(f"[4 wgs] stages s, engine numpy: "
        f"{json.dumps({k: round(v, 3) for k, v in st_n.items()})}")
    log(f"[4 wgs] batch scorer (K2 + int64 coverage) over {len(packed[0])} "
        f"pairs, {len(starts)} reads, {len(ic)} intervals: {t_score:.3f} s, "
        f"support {support.tolist()} == numpy, coverage exact")
    log(f"[4 wgs] K1, K2 == plain at the main path's shape ({len(cols[0])} "
        f"pairs, {len(ic)} intervals)")
    log(f"[4 wgs] launches in the main path's run: {launches}")
    return launches, errs


# -- phase 5 --------------------------------------------------------------

def phase_cycles(work: str) -> None:
    from coral_tpu.sim import simulate_mixed_sample

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
    sys.path.insert(0, ROOT)
    smi = phase_env()
    phase_build()
    report = phase_kernels()
    with tempfile.TemporaryDirectory() as work:
        launches, wgs_errs = phase_main_path(work)
    with tempfile.TemporaryDirectory() as work:
        phase_cycles(work)
    require(not any(m == "jax" or m.startswith("jax.") for m in sys.modules),
            "jax was imported")
    replaces = {"pair3": "coral_tpu/ops/pallas_kernels.py:378",
                "pair3_support": "coral_tpu/ops/pallas_kernels.py:473"}
    kern = []
    for name, rows in report.items():
        # the timing of the dense case (about half the pairs hit)
        err = max([r[0] for r in rows] + [wgs_errs[name]])
        kern.append({"name": name, "route": "cuda", "source": SOURCE,
                     "replaces": replaces[name], "launches": launches[name],
                     "max_abs_err": err, "ms": rows[-1][1],
                     "plain_ms": rows[-1][2]})
    log(f"gpu: {smi}")
    log(json.dumps({"kernels": kern}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
