#!/usr/bin/env python3
"""End-to-end quickstart of the port (its counterpart of
``examples/quickstart.py``): simulate an ecDNA sample, then drive all five
CLI modes on it through ``python -m coral_tpu_torch``, as a user would.

    python -m coral_tpu_torch.tools.quickstart [WORKDIR] [--device cuda|cpu]

Writes everything under WORKDIR (default ``quickstart_out``) and prints
each command before running it.  ``reconstruct`` runs its engines on
``--device`` (``cuda`` by default: the ``cuda`` pair-scoring engine; with
``cpu`` the ``torch`` engine).  ``plot`` and ``hsr`` need matplotlib.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run(argv):
    print("\n$ python -m coral_tpu_torch " + " ".join(argv), flush=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    subprocess.run([sys.executable, "-m", "coral_tpu_torch", *argv],
                   env=env, check=True)


def quickstart(workdir, device="cuda"):
    """The five modes on a simulated sample under ``workdir``; returns
    the cycles file of amplicon 1."""
    from ..device import resolve_device
    from ..sim import simulate_ecdna

    dev = resolve_device(device)
    workdir = os.path.abspath(workdir)
    os.makedirs(workdir, exist_ok=True)
    print(f"== Simulating an ecDNA sample under {workdir}")
    bam, cns, _seeds = simulate_ecdna(workdir)
    prefix = os.path.join(workdir, "sample")

    # 1. seed: CN calls -> amplified seed intervals (--out is the full
    # output filename, used verbatim)
    seeds_bed = prefix + "_CNV_SEEDS.bed"
    run(["seed", "--cn_seg", cns, "--out", seeds_bed])

    # 2. reconstruct: BAM + seeds -> breakpoint graph + cycles
    engine = "cuda" if dev.type == "cuda" else "torch"
    run(["reconstruct", "--lr_bam", bam, "--cnv_seed", seeds_bed,
         "--cn_seg", cns, "--output_prefix", prefix,
         "--engine", engine, "--device", str(dev),
         "--log_fn", os.path.join(workdir, "reconstruct.log")])

    graph = prefix + "_amplicon1_graph.txt"
    cycles = prefix + "_amplicon1_cycles.txt"

    # 3. plot: graph sashimi + cycle decomposition figures
    run(["plot", "--ref", "GRCh38", "--bam", bam, "--graph", graph,
         "--cycles", cycles, "--output_prefix", prefix,
         "--plot_graph", "--plot_cycles"])

    # 4. hsr: candidate chromosomal integration sites
    run(["hsr", "--lr_bam", bam, "--cycles", cycles, "--cn_seg", cns,
         "--output_prefix", prefix, "--normal_cov", "20"])

    # 5. cycle2bed: AA cycles -> flat bed table
    run(["cycle2bed", "--cycle_fn", cycles,
         "--output_fn", prefix + "_cycles.bed"])

    print("\n== Outputs under", workdir)
    for name in sorted(os.listdir(workdir)):
        print("  ", name)
    print("\nCycles:")
    with open(cycles) as fp:
        for line in fp:
            if line.startswith("Cycle="):
                print("  ", line.rstrip())
    return cycles


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("workdir", nargs="?", default="quickstart_out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    quickstart(args.workdir, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
