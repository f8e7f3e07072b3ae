#!/usr/bin/env python3
"""Shard-ingest scaling benchmark (the port's counterpart of
``tools/bench_multihost.py``): reconstruct wall time at N scanning
processes.

Builds the WGS-scale sample of :mod:`bench_wgs` (8.7 M records by
default), splits it into N contiguous shards
(``parallel.multihost.split_bam``, the per-host staging of a multi-host
deployment), and times ``multihost_reconstruct_graphs`` at N = 1, 2 and 4:
the scan fans out one process per shard; the stages after the merge run
in this process, their device engines on ``--device``, on products merged
in shard order, so the graph files are byte-identical across N.  Each N
runs ``reps`` times (2 by default) and the minimum is reported.

    python -m coral_tpu_torch.tools.bench_multihost [WORKDIR] [REPS]
        [--device cuda|cpu]

Prints one JSON line per N, then a line of scaling efficiencies.
"""
from __future__ import annotations

import argparse
import json
import os
import time

PROCESSES = (1, 2, 4)


def scaling(bam, seeds, cns, workdir, ns=PROCESSES, reps=2, *, cfg=None,
            device="cuda"):
    """For each N of ``ns``: ``split_bam`` into N shards under ``workdir``
    (N = 1 scans ``bam`` itself), then ``reps`` runs of
    ``multihost_reconstruct_graphs`` with the graph files at
    ``workdir/out_n<N>``.  Yields a dict per N: ``processes``,
    ``split_s``, ``wall_s`` (the minimum), ``started`` (the
    ``time.perf_counter()`` at which the last run began), ``prefix`` and
    ``rec`` (the last run's ``Reconstruction``, its BAM view open)."""
    from ..parallel import multihost

    for n in ns:
        t0 = time.perf_counter()
        shards = [bam] if n == 1 else multihost.split_bam(bam, [
            os.path.join(workdir, f"shard{n}_{k}.bam") for k in range(n)])
        split_s = time.perf_counter() - t0
        prefix = os.path.join(workdir, f"out_n{n}")
        best = float("inf")
        for r in range(reps):
            if r:
                rec.bam.close()
            started = time.perf_counter()
            rec = multihost.multihost_reconstruct_graphs(
                shards, seeds, cns, prefix, cfg=cfg, device=device)
            best = min(best, time.perf_counter() - started)
        yield {"processes": n, "split_s": split_s, "wall_s": best,
               "started": started, "prefix": prefix, "rec": rec}


def main(argv=None) -> int:
    from ..device import resolve_device
    from .bench_wgs import build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("workdir", nargs="?", default="bench_multihost_out")
    ap.add_argument("reps", nargs="?", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(os.path.join(args.workdir, "input"), exist_ok=True)
    bam, cns, seeds, _ = build(os.path.join(args.workdir, "input"))

    results = {}
    for row in scaling(bam, seeds, cns, args.workdir, reps=args.reps,
                       device=device):
        n, best = row["processes"], row["wall_s"]
        row["rec"].bam.close()
        results[n] = best
        print(json.dumps({
            "metric": "multihost reconstruct (scan fan-out)",
            "processes": n, "wall_s": round(best, 2),
            "amplicons": len(row["rec"].graphs),
            "speedup_vs_1": round(results[1] / best, 2),
        }), flush=True)
    print(json.dumps({
        "metric": "shard-ingest scaling efficiency",
        "eff_2": round(results[1] / results[2] / 2, 2),
        "eff_4": round(results[1] / results[4] / 4, 2),
        "host_cpus": os.cpu_count(),
        "device": str(device),
        "note": "the scan fans out over processes, the merge of their "
                "products and every stage after it run in this process; "
                "the N-shard graph files are byte-identical to 1 shard's "
                "(tests/test_torch_multihost.py)",
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
