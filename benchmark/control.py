#!/usr/bin/env python3
"""Readings that the limits of the check are set from (not part of a run).

    python3 benchmark/control.py --workload CELL --seeds 1,2,3 [--program 0]

For each seed: the cell's sample is written, reconstructed once by the
program as a run's window does, and compared with the reference (the
lower readings); then the reference itself, with its CN balance computed
in float32 instead of the float64 the configuration states, is put in the
program's place and compared the same way (the control, whose readings are
the upper ones).  ``--program 0`` leaves the program out and reads the
control alone.  One JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import run  # noqa: E402
import registry  # noqa: E402


def readings(c, seeds, overrides=None, out=sys.stdout, program=True):
    import compare
    import generator
    from outputs import gather

    with_cycles = "--skip_cycle_decomp" not in c.config["cli"]
    cfg, args = run.build_cfg(c.config["cli"], overrides)
    lim = c.config["check"]
    rows = []
    work = tempfile.mkdtemp(prefix="coral-control-",
                            dir=os.environ.get("TMPDIR"))
    try:
        for seed in seeds:
            d = os.path.join(work, str(seed))
            t0 = time.perf_counter()
            s = generator.write_sample(os.path.join(d, "in"), c.mix, seed)
            t1 = time.perf_counter()
            ref = compare.Reference(c.mix, seed, s.cns, s.seeds,
                                    c.config["constants"])
            row = {"workload": c.name, "seed": seed, "write_s": t1 - t0}
            if program:
                prefix = os.path.join(d, "o")
                cn = run.reconstruct_once(s.bam, s.seeds, s.cns, prefix, cfg,
                                          args.device, with_cycles)
                run.sync(args.device)
                row["sample_s"] = time.perf_counter() - t1
                sound = compare.new_state(with_cycles, ref.simple)
                compare.judge_sample(gather(prefix, cn, with_cycles), ref,
                                     with_cycles, sound)
                row.update(program=sound,
                           program_ok=compare.verdict(sound, lim))
            t2 = time.perf_counter()
            ctl = compare.new_state(with_cycles, ref.simple)
            compare.judge_sample(compare.control_outputs(ref, with_cycles),
                                 ref, with_cycles, ctl)
            row.update(control=ctl, control_ok=compare.verdict(ctl, lim),
                       reference_s=time.perf_counter() - t2)
            rows.append(row)
            print(json.dumps(row), file=out, flush=True)
            shutil.rmtree(d, ignore_errors=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    c = registry.cell(registry.load_spec(run.ROOT), args.workload)
    readings(c, [int(s) for s in args.seeds.split(",")],
             program=bool(args.program))
    return 0


if __name__ == "__main__":
    sys.exit(main())
