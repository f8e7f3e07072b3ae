#!/usr/bin/env python3
"""Whole-genome-scale end-to-end benchmark (the port's counterpart of
``tools/bench_wgs.py``): one simulated ecDNA amplicon replicated across 10
real chromosome names (8.7 M records by default), then the whole
reconstruction pipeline (scan, chimera collect, interval search,
breakpoints, graph build, CN balance, cycle decomposition) over all 10
amplicons, with each stage's wall time.

    python -m coral_tpu_torch.tools.bench_wgs [OUT] [--engine E]
        [--repeat N] [--junction-heavy] [--device cuda|cpu]

Real chromosome names are needed because breakpoint canonicalization keys
on the hg38 chromosome order; only 4-character names can replace the
template's embedded "chr7" SA rnames in place, so chr1..chr9 and chrX are
used.

  --engine auto|numpy|torch|cuda   pair-scoring engine of the breakpoints
                                   stage
  --repeat N                       min-of-N per stage
  --junction-heavy                 the junction-dominated variant (1.5 M
                                   chimeric pairs, 5,179,920 records),
                                   graphs only
  --device                         where the torch and cuda engines run
                                   (cuda by default; cpu only when asked)

A stage that runs on the card ends in ``torch.cuda.synchronize()``.
Prints one JSON object.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import struct
import time

CHROMS = [f"chr{i}" for i in range(1, 10)] + ["chrX"]
CHR_LEN = 159_345_973


def build(out_dir, read_len=1500, n_junction_reads=2000, junction_flank=10_000,
          bg_cov=20, name="wgs"):
    """The simulated sample replicated onto :data:`CHROMS`, written under
    ``out_dir`` byte for byte as ``tools/bench_wgs.build`` writes it.
    Returns (bam, cns, seeds, records)."""
    from ..io.bgzf import BGZF_EOF, iter_blocks, write_bgzf
    from ..sim import simulate_ecdna

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
        f"@SQ\tSN:{c}\tLN:{CHR_LEN}\n" for c in CHROMS)).encode()
    header = b"BAM\x01" + struct.pack("<i", len(text)) + text \
        + struct.pack("<i", len(CHROMS))
    for c in CHROMS:
        nb = c.encode() + b"\x00"
        header += struct.pack("<i", len(nb)) + nb + struct.pack("<i", CHR_LEN)

    big_path = os.path.join(out_dir, f"{name}.bam")
    with open(big_path, "wb") as fp:
        write_bgzf(fp, bytes(header), level=1)
        for ci, c in enumerate(CHROMS):
            # the chromosome in each record, and the read names' prefix
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
        for c in CHROMS:
            for row in cns_rows:
                fp.write(c + row[row.index("\t"):] + "\n")
    seeds_path = os.path.join(out_dir, f"{name}_seeds.bed")
    with open(seeds_path, "w") as fp:
        for c in CHROMS:
            fp.write(f"{c}\t55000000\t55399999\n")
    return big_path, cns_path, seeds_path, len(rel) * len(CHROMS)


def build_junction_heavy(out_dir):
    """The junction-dominated 10-chromosome sample
    (``tools/bench_wgs.build_junction_heavy``): 1.5 M chimeric reads of one
    adjacent pair each over a modest background, 5,179,920 records."""
    return build(out_dir, read_len=1500, n_junction_reads=150_000,
                 junction_flank=50, bg_cov=4, name="wgs_hvy")


class _RouteLines(logging.Handler):
    """Keeps the pair-scoring route lines the breakpoints stage logs."""

    def __init__(self):
        super().__init__(level=logging.INFO)
        self.lines = []

    def emit(self, record):
        msg = record.getMessage()
        if "pair scoring route" in msg:
            self.lines.append(msg)


def run_staged(bam, cns, seeds, prefix, engine="auto", skip_cycles=False, *,
               device="cuda", on_graphs=None):
    """One staged reconstruct run (``tools/bench_wgs.run_staged``); returns
    (stages dict, route log lines, output file map, n_amplicons, route
    records).  The stages: ``scan+collect``, ``interval_search``,
    ``smalldel``, ``breakpoints``, ``graph+cn``, then ``cycles`` or, with
    ``skip_cycles``, ``write_graphs`` (the graph files alone), and
    ``total``, in s rounded to 0.01.  The route records are the
    :class:`coral_tpu_torch.ops.pairs.RouteRecord` entries this run
    appended (engine, pairs, scoring seconds, the decision's reason).

    ``on_graphs(rec)``, when given, is called with the
    :class:`~coral_tpu_torch.reconstruct.Reconstruction` once its graphs
    are built and their coverage assigned, before CN; its time is left
    out of the stages.  The BAM is closed when the run ends."""
    from ..graph.breakpoint_graph import write_graph_file
    from ..io.bam import BamFile
    from ..ops import pairs as pairs_mod
    from ..reconstruct import Reconstruction, reconstruct_cycles
    from .bench_common import engine_config, sync

    cfg = engine_config(engine)
    rec_seq = pairs_mod.last_route_seq()
    handler = _RouteLines()
    lg = logging.getLogger(pairs_mod.__name__)
    old_level = lg.level
    lg.addHandler(handler)
    lg.setLevel(logging.INFO)
    stages = {}
    try:
        t_all = t0 = time.time()
        bamf = BamFile(bam)
        rec = Reconstruction(bamf, seeds, cfg, device=device)
        rec.read_cns(cns)
        rec.collect()
        stages["scan+collect"] = round(time.time() - t0, 2)
        t0 = time.time()
        rec.hash_to_segments()
        rec.find_amplicon_intervals()
        stages["interval_search"] = round(time.time() - t0, 2)
        t0 = time.time()
        rec.find_smalldel_breakpoints()
        stages["smalldel"] = round(time.time() - t0, 2)
        t0 = time.time()
        rec.find_breakpoints()
        sync(device)
        stages["breakpoints"] = round(time.time() - t0, 2)
        t0 = time.time()
        rec.build_graph()
        rec.assign_cov()
        t_hook = time.time()
        if on_graphs is not None:
            on_graphs(rec)
        t_hook = time.time() - t_hook
        rec.compute_cn()
        sync(device)
        stages["graph+cn"] = round(time.time() - t0 - t_hook, 2)
        t0 = time.time()
        if not skip_cycles:
            reconstruct_cycles(rec, prefix)
            stages["cycles"] = round(time.time() - t0, 2)
        else:
            for gi, g in enumerate(rec.graphs):
                write_graph_file(g, f"{prefix}_amplicon{gi + 1}_graph.txt")
            stages["write_graphs"] = round(time.time() - t0, 2)
        stages["total"] = round(time.time() - t_all - t_hook, 2)
        n_amp = len(rec.graphs)
        bamf.close()
    finally:
        lg.removeHandler(handler)
        lg.setLevel(old_level)
    files = {}
    d = os.path.dirname(prefix)
    base = os.path.basename(prefix)
    for f in sorted(os.listdir(d)):
        if f.startswith(base + "_") and f.endswith(
                ("_graph.txt", "_cycles.txt")):
            with open(os.path.join(d, f)) as fh:
                files[f] = fh.read()
    return stages, handler.lines, files, n_amp, \
        pairs_mod.route_records_since(rec_seq)


def main(argv=None) -> int:
    from ..device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default="wgs_out")
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "numpy", "torch", "cuda"])
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--junction-heavy", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    t0 = time.time()
    if args.junction_heavy:
        bam, cns, seeds, n_rec = build_junction_heavy(args.out)
    else:
        bam, cns, seeds, n_rec = build(args.out)
    build_s = round(time.time() - t0, 2)

    best = None
    runs = []
    for r in range(max(args.repeat, 1)):
        prefix = os.path.join(args.out, f"wgs_out_r{r}")
        stages, _, _, n_amp, _ = run_staged(
            bam, cns, seeds, prefix, engine=args.engine,
            skip_cycles=args.junction_heavy, device=device)
        runs.append(stages)
        if best is None or stages["total"] < best["total"]:
            best = stages
    ok = 0
    last_prefix = os.path.join(args.out, f"wgs_out_r{len(runs) - 1}")
    for i in range(1, n_amp + 1):
        path = f"{last_prefix}_amplicon{i}_cycles.txt"
        if os.path.exists(path):
            with open(path) as fh:
                ok += "Cycle=" in fh.read()
    stages_min = {k: min(s[k] for s in runs) for k in runs[0]}
    print(json.dumps({
        "n_records": n_rec,
        "n_amplicons": n_amp,
        "amplicons_with_cycles": ok,
        "build_input_s": build_s,
        "engine": args.engine,
        "device": str(device),
        "repeats": len(runs),
        "stages_s_min_of_n": stages_min,
        "stages_s_runs": runs,
        "reconstruct_total_s": best["total"],
        "records_per_s": round(n_rec / max(best["total"], 1e-9)),
    }, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
