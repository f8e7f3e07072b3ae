"""Command line of the port: ``python -m coral_tpu_torch <mode>``.

The five modes of ``coral_tpu`` (the reference's ``seed``, ``reconstruct``,
``hsr``, ``plot`` and ``cycle2bed``), with its flags, defaults and help.
``reconstruct`` takes the port's engines and a ``--device``; its
``--shard_devices N`` shards pair scoring and the CN balance over a mesh of
the first N CUDA devices (or, with ``--device cpu``, of N CPU shards), and
raises when fewer cards are present.  ``hsr`` and ``plot`` are host code
that needs matplotlib; the other modes do not load it.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import time


def _print_args(args) -> None:
    for key, value in vars(args).items():
        print(f"{key}: {value}")
    print()


def seed_mode(args) -> None:
    print("Performing seeding mode with options:")
    _print_args(args)
    from .config import SeedConfig
    from .seed import run_seeding
    cfg = SeedConfig(
        gain=args.gain, min_seed_size=args.min_seed_size,
        max_seg_gap=args.max_seg_gap)
    run_seeding(args.cn_seg, args.out, cfg)


def reconstruct_mode(args) -> None:
    print("Performing reconstruction with options:")
    _print_args(args)
    from .config import DEFAULT_CONFIG
    from .reconstruct import reconstruct_cycles, reconstruct_graphs
    from .tracing import setup_file_logging

    setup_file_logging(args.log_fn or "infer_breakpoint_graph.log")
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
    mesh = None
    if args.shard_devices:
        from .device import resolve_device
        from .parallel.mesh import make_mesh

        n = args.shard_devices
        if resolve_device(args.device).type == "cpu":
            mesh = make_mesh(n, cfg.parallel.dp_axis, devices=["cpu"] * n)
        else:
            mesh = make_mesh(n, cfg.parallel.dp_axis)
        logging.getLogger(__name__).info(
            "pair scoring sharded over %d device(s): %s", n, mesh)
    rec = reconstruct_graphs(
        args.lr_bam, args.cnv_seed, args.cn_seg, args.output_prefix,
        cfg=cfg, output_bp=args.output_bp, scan_cache=args.scan_cache,
        mesh=mesh, device=args.device)
    if not (args.output_bp or args.skip_cycle_decomp):
        reconstruct_cycles(
            rec, args.output_prefix,
            output_all_path_constraints=args.output_all_path_constraints)
    rec.bam.close()
    logging.getLogger(__name__).info("Total runtime: %.4f s",
                                     time.time() - t0)
    print("\nCompleted reconstruction.")


def hsr_mode(args) -> None:
    print("Performing HSR mode with options:")
    _print_args(args)
    from .hsr import locate_hsrs
    locate_hsrs(args)


def plot_mode(args) -> None:
    print("Performing plot mode with options:")
    _print_args(args)
    from .plot.plot_amplicons import plot_amplicons
    plot_amplicons(args)


def cycle2bed_mode(args) -> None:
    print("Performing cycle to bed mode with options:")
    _print_args(args)
    from .cycle2bed import convert_cycles_to_bed
    convert_cycles_to_bed(
        args.cycle_fn, args.output_fn, bool(args.rotate_to_min), args.num_cycles)


def build_parser() -> argparse.ArgumentParser:
    from . import __version__

    parser = argparse.ArgumentParser(
        prog="coral_tpu_torch",
        description="Long-read amplicon reconstruction on PyTorch + CUDA "
                    "(port of coral_tpu).")
    parser.add_argument("--version", action="version",
                        version=f"%(prog)s {__version__}")
    sub = parser.add_subparsers(dest="mode", help="Select mode.")

    p = sub.add_parser("seed", help="Filter and merge amplified intervals.")
    p.add_argument("--cn_seg", required=True,
                   help="Long read segmented whole genome CN calls "
                        "(.bed or CNVkit .cns file).")
    p.add_argument("--out", type=str, default="",
                   help="Prefix filename for output bed file.")
    p.add_argument("--gain", type=float, default=6.0,
                   help="CN gain threshold for interval to be considered a seed.")
    # the reference's real defaults are its CNSIZE_MIN/CNGAP_MAX constants
    # (99999/300001, cnv_seed.py:7-9 wired at CoRAL.py:75-79); its help
    # text "100000"/"300000" is off by one from the code
    p.add_argument("--min_seed_size", type=int, default=99999,
                   help="Minimum size (in bp) for a seed interval.")
    p.add_argument("--max_seg_gap", type=int, default=300001,
                   help="Maximum gap size (in bp) to merge two proximal intervals.")

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
    p.add_argument("--cn_engine",
                   choices=["auto", "numpy", "torch", "batch"],
                   default="auto",
                   help="CN-balance solver: numpy f64, torch f64 on --device "
                        "(one graph at a time), batch (every amplicon's "
                        "system in one f64 solve on --device), or auto "
                        "(batch from 32 amplicons up, numpy below).")
    p.add_argument("--device", default="cuda",
                   help="Device of the torch, cuda and batch engines: cuda, "
                        "cuda:N or cpu.  A CUDA device that is not there is "
                        "an error.")
    p.add_argument("--shard_devices", type=int, default=0,
                   help="Shard pair scoring and the CN balance over a mesh "
                        "of this many devices: the first N CUDA devices, or "
                        "N shards of --device cpu (0 = off).  Fewer cards "
                        "than N is an error.")

    p = sub.add_parser(
        "hsr", help="Detect possible integration points of ecDNA HSR amplifications.")
    p.add_argument("--lr_bam", required=True, help="Sorted indexed long read bam file.")
    p.add_argument("--cycles", required=True, help="AmpliconSuite-formatted cycles file")
    p.add_argument("--cn_seg", required=True,
                   help="Long read segmented whole genome CN calls.")
    p.add_argument("--output_prefix", required=True, help="Prefix of output file name.")
    p.add_argument("--normal_cov", required=True, help="Estimated diploid coverage.")
    p.add_argument("--bp_match_cutoff", type=int, default=100,
                   help="Breakpoint matching cutoff.")
    p.add_argument("--bp_match_cutoff_clustering", type=int, default=2000,
                   help="Crude breakpoint matching cutoff for clustering.")

    p = sub.add_parser(
        "plot", help="Generate plots of amplicon cycles and/or graph "
                     "from AA-formatted output files")
    p.add_argument("--ref", choices=["hg19", "hg38", "GRCh38", "mm10", "GRCh37"],
                   required=True, help="Name of reference genome used")
    p.add_argument("--bam", help="Sorted & indexed bam file.")
    p.add_argument("--graph", help="AmpliconSuite-formatted *.graph file.")
    p.add_argument("--cycles", help="AmpliconSuite-formatted cycles file.")
    p.add_argument("--output_prefix", "-o", required=True,
                   help="Prefix of output files.")
    p.add_argument("--plot_graph", action="store_true",
                   help="Visualize breakpoint graph.")
    p.add_argument("--plot_cycles", action="store_true",
                   help="Visualize (selected) cycles.")
    p.add_argument("--only_cyclic_paths", action="store_true",
                   help="Only plot cyclic paths from cycles file")
    p.add_argument("--num_cycles", type=int,
                   help="Only plot the first NUM_CYCLES cycles.")
    p.add_argument("--max_coverage", type=float, default=float("inf"),
                   help="Limit the maximum visualized coverage in the graph")
    p.add_argument("--min_mapq", type=float, default=0,
                   help="Minimum mapping quality to count reads in coverage plotting")
    p.add_argument("--gene_subset_list", nargs="+", default=[],
                   help="List of genes to visualize")
    p.add_argument("--hide_genes", action="store_true", default=False,
                   help="Do not show gene track")
    p.add_argument("--gene_fontsize", type=float, default=12,
                   help="Change size of gene font")
    p.add_argument("--bushman_genes", action="store_true", default=False,
                   help="Reduce gene set to the Bushman cancer-related gene set")
    p.add_argument("--region",
                   help="Specifically visualize only this region "
                        "('chr1:pos1-pos2').")

    p = sub.add_parser("cycle2bed", help="Convert cycle files in AA format to bed.")
    p.add_argument("--cycle_fn", required=True, help="Input AA-formatted cycle file.")
    p.add_argument("--output_fn", required=True, help="Output file name.")
    p.add_argument("--num_cycles", type=int,
                   help="Only convert the first NUM_CYCLES cycles.")
    p.add_argument("--rotate_to_min", action="store_true",
                   help="Output cycles starting from the canonically smallest "
                        "segment with positive strand.")
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    dispatch = {
        "seed": seed_mode,
        "reconstruct": reconstruct_mode,
        "hsr": hsr_mode,
        "plot": plot_mode,
        "cycle2bed": cycle2bed_mode,
    }
    if args.mode in dispatch:
        dispatch[args.mode](args)
        return 0
    parser.print_help()
    return 1
