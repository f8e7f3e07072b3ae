#!/usr/bin/env python3
"""End-to-end reconstruct benchmark report (the port's counterpart of
``tools/bench_e2e.py``): the wall time of each pipeline stage on a
simulated ecDNA sample, as one JSON report.

    python -m coral_tpu_torch.tools.bench_e2e [OUT_DIR] [N_JUNCTION]
        [--engine auto|numpy|torch|cuda] [--cn_engine auto|numpy|torch|batch]
        [--device cuda|cpu]

The sample is ``simulate_ecdna(jitter=2, n_junction_reads=N_JUNCTION,
bg_read_len=5000, amp_read_len=5000)`` (N_JUNCTION 5,000 by default).  The
report goes to stdout and to ``OUT_DIR/bench_e2e.json``; the graph and
cycles files to ``OUT_DIR/bench_amplicon*``.  ``--engine`` scores pairs,
``--cn_engine`` balances CN, both on ``--device`` (``cuda`` by default;
``cpu`` only when asked); a stage that runs on the card ends in
``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

STAGES = ("bam_scan", "read_cns", "collect_chimeras", "hash_to_segments",
          "find_amplicon_intervals", "find_smalldel_breakpoints",
          "find_breakpoints", "build_graph", "assign_cov", "compute_cn",
          "cycles_stage")


def run(out_dir, n_junction=5000, engine="auto", cn_engine="auto", *,
        device="cuda") -> dict:
    """Simulate the sample under ``out_dir``, reconstruct it stage by stage
    with its graph and cycles files, and return the report (keys
    ``n_records``, ``n_chimeras``, ``n_breakpoints``, ``stages_s`` in
    :data:`STAGES` order, ``total_s``, ``records_per_s``)."""
    from ..graph.breakpoint_graph import write_graph_file
    from ..io.bam import BamFile
    from ..reconstruct import Reconstruction, reconstruct_cycles
    from ..sim import simulate_ecdna
    from .bench_common import engine_config, sync

    os.makedirs(out_dir, exist_ok=True)
    bam_p, cns_p, seeds_p = simulate_ecdna(
        out_dir, jitter=2, n_junction_reads=n_junction,
        bg_read_len=5000, amp_read_len=5000)
    prefix = os.path.join(out_dir, "bench")
    stages = {}

    def timed(name, fn):
        t0 = time.time()
        out = fn()
        sync(device)
        stages[name] = round(time.time() - t0, 3)
        return out

    bam = timed("bam_scan", lambda: BamFile(bam_p))
    rec = Reconstruction(bam, seeds_p, engine_config(engine, cn_engine),
                         device=device)
    timed("read_cns", lambda: rec.read_cns(cns_p))
    timed("collect_chimeras", rec.collect)
    timed("hash_to_segments", rec.hash_to_segments)
    timed("find_amplicon_intervals", rec.find_amplicon_intervals)
    timed("find_smalldel_breakpoints", rec.find_smalldel_breakpoints)
    timed("find_breakpoints", rec.find_breakpoints)
    timed("build_graph", rec.build_graph)
    timed("assign_cov", rec.assign_cov)
    timed("compute_cn", rec.compute_cn)
    timed("cycles_stage", lambda: reconstruct_cycles(rec, prefix))
    # the graph files too (the cycles stage writes only the cycles), so
    # that two runs can be compared file for file; not timed
    for gi, g in enumerate(rec.graphs):
        write_graph_file(g, f"{prefix}_amplicon{gi + 1}_graph.txt")
    bam.close()
    total = sum(stages.values())
    return {
        "n_records": bam.n_records,
        "n_chimeras": len(rec.chimeras),
        "n_breakpoints": len(rec.new_bp_list),
        "stages_s": stages,
        "total_s": round(total, 3),
        "records_per_s": round(bam.n_records / max(total, 1e-9)),
    }


def main(argv=None) -> int:
    from ..device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir", nargs="?", default="bench_e2e_out")
    ap.add_argument("n_junction", nargs="?", type=int, default=5000)
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "numpy", "torch", "cuda"])
    ap.add_argument("--cn_engine", default="auto",
                    choices=["auto", "numpy", "torch", "batch"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    report = run(args.out_dir, args.n_junction, args.engine, args.cn_engine,
                 device=resolve_device(args.device))
    print(json.dumps(report, indent=1))
    with open(os.path.join(args.out_dir, "bench_e2e.json"), "w") as fp:
        json.dump(report, fp, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
