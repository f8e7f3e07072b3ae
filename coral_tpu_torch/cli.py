"""Command line of the port: ``python -m coral_tpu_torch reconstruct``.

The ``reconstruct`` flags are those of ``coral_tpu reconstruct`` (the
reference's names and defaults), with the port's engines and a
``--device``.  The other modes of ``coral_tpu`` are not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import time


def _setup_logging(log_fn: str) -> None:
    """The JAX package's ``#TIME`` trace file, also fed by the port's
    loggers."""
    from coral_tpu.tracing import setup_file_logging

    setup_file_logging(log_fn)
    src = logging.getLogger("coral_tpu")
    port = logging.getLogger("coral_tpu_torch")
    port.setLevel(src.level)
    for h in src.handlers:
        port.addHandler(h)
    port.propagate = False


def reconstruct_mode(args) -> None:
    print("Performing reconstruction with options:")
    for key, value in vars(args).items():
        print(f"{key}: {value}")
    print()
    from coral_tpu.config import DEFAULT_CONFIG

    from .reconstruct import reconstruct_cycles, reconstruct_graphs

    _setup_logging(args.log_fn or "infer_breakpoint_graph.log")
    t0 = time.time()
    cfg = DEFAULT_CONFIG
    cfg = cfg.replace(
        bp=dataclasses.replace(cfg.bp, min_bp_cov_factor=args.min_bp_support,
                               nm_filter=args.filter_bp_by_edit_distance),
        cycles=dataclasses.replace(
            cfg.cycles,
            alpha=args.cycle_decomp_alpha,
            time_limit_s=args.cycle_decomp_time_limit,
            threads=args.cycle_decomp_threads or -1,
            postprocess=bool(args.postprocess_greedy_sol),
        ),
        engine=dataclasses.replace(
            cfg.engine, engine=args.engine, cn_engine=args.cn_engine),
    )
    rec = reconstruct_graphs(
        args.lr_bam, args.cnv_seed, args.cn_seg, args.output_prefix,
        cfg=cfg, output_bp=args.output_bp, scan_cache=args.scan_cache,
        device=args.device)
    if not (args.output_bp or args.skip_cycle_decomp):
        reconstruct_cycles(
            rec, args.output_prefix,
            output_all_path_constraints=args.output_all_path_constraints)
    rec.bam.close()
    logging.getLogger(__name__).info("Total runtime: %.4f s",
                                     time.time() - t0)
    print("\nCompleted reconstruction.")


def build_parser() -> argparse.ArgumentParser:
    from . import __version__

    parser = argparse.ArgumentParser(
        prog="coral_tpu_torch",
        description="Long-read amplicon reconstruction on PyTorch + CUDA "
                    "(port of coral_tpu).")
    parser.add_argument("--version", action="version",
                        version=f"%(prog)s {__version__}")
    sub = parser.add_subparsers(dest="mode", help="Select mode.")

    p = sub.add_parser("reconstruct", help="Reconstruct focal amplifications")
    p.add_argument("--lr_bam", required=True,
                   help="Sorted indexed (long read) bam file.")
    p.add_argument("--cnv_seed", required=True,
                   help="Bed file of CNV seed intervals.")
    p.add_argument("--output_prefix", required=True,
                   help="Prefix of output files.")
    p.add_argument("--cn_seg", required=True,
                   help="Long read segmented whole genome CN calls.")
    p.add_argument("--output_bp", action="store_true",
                   help="If specified, only output the list of breakpoints.")
    p.add_argument("--skip_cycle_decomp", action="store_true",
                   help="Only reconstruct and output the breakpoint graph.")
    p.add_argument("--output_all_path_constraints", action="store_true",
                   help="Output all path constraints in *.cycles file.")
    p.add_argument("--scan_cache", action="store_true",
                   help="Persist the BAM scan to <bam>.scanx and resume "
                        "from it on re-runs while the BAM is unchanged.")
    p.add_argument("--min_bp_support", type=float, default=1.0,
                   help="Ignore breakpoints with less than (min_bp_support * "
                        "normal coverage) long read support.")
    p.add_argument("--cycle_decomp_alpha", type=float, default=0.01,
                   help="Balance between CN weight and path constraints.")
    p.add_argument("--cycle_decomp_time_limit", type=int, default=7200,
                   help="Maximum running time (in seconds) for the solver.")
    p.add_argument("--cycle_decomp_threads", type=int,
                   help="Number of threads reserved for the solver.")
    p.add_argument("--filter_bp_by_edit_distance", action="store_true",
                   help="Filter breakpoints derived from alignments with "
                        "large (> mean + 3 * std) edit distance.")
    p.add_argument("--postprocess_greedy_sol", action="store_true",
                   help="Postprocess the greedy cycles/paths solution.")
    p.add_argument("--log_fn", help="Name of log file.")
    p.add_argument("--engine", choices=["auto", "numpy", "torch", "cuda"],
                   default="auto",
                   help="Pair-scoring engine: numpy (host), torch (the "
                        "predicate on --device; the only one with the NM "
                        "gate), cuda (the hand-written CUDA kernel), or auto "
                        "(numpy below 2^18 pairs or on a CPU device, cuda "
                        "otherwise).")
    p.add_argument("--cn_engine", choices=["auto", "numpy", "torch"],
                   default="auto",
                   help="CN-balance solver: numpy f64, torch f64 on --device, "
                        "or auto (numpy).")
    p.add_argument("--device", default="cuda",
                   help="Device of the torch and cuda engines: cuda, cuda:N "
                        "or cpu.  A CUDA device that is not there is an "
                        "error.")
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.mode == "reconstruct":
        reconstruct_mode(args)
        return 0
    parser.print_help()
    return 1
