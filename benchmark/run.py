#!/usr/bin/env python3
"""Benchmark of ``coral_tpu_torch`` reconstructing whole samples on one card.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``:
the ``reconstruct`` options, the constants and limits of the check) and a
traffic mix (``traffic/<name>.json``: the sample's parameters).  Set-up
writes the mix's sample from ``--seed`` into a fresh directory under
``$TMPDIR`` and reconstructs it once to warm up.  The window then
reconstructs the sample again and again, each time as the command
line does (``reconstruct_graphs``, then ``reconstruct_cycles`` unless the
configuration skips cycles, then ``rec.bam.close()``), starting samples
until ``--seconds`` have passed and letting the last one finish.

With ``--trace 0`` the last line of standard output holds the cell's
end-to-end metrics: the process's CPU seconds (every thread, user and
system) over the window per sample, the window's peak resident set and
the set-up time; with ``--trace 1`` its per-layer metrics, among them the
window's wall-clock rate of BAM records, read from
spans the benchmark installs around the program's functions, the program's
own counters and the profiler's device trace.  After the window every
sample's outputs are compared with the NumPy reference
(``reference/compare.py``); each number compared and its limit are printed
last on standard error and under ``check`` in the result line.

Exits non-zero without a result when there is no CUDA card, when fewer
cards than the cell asks for are present, or when the process holds JAX or
the JAX package once the window has closed.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback

# one thread for the BLAS and OpenMP pools: the load is one process whose
# host stages run on one thread (the BAM scan's own inflate threads aside)
for _v in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_v, "1")

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, os.path.join(BENCH, "core"), os.path.join(BENCH, "traffic"),
           os.path.join(BENCH, "reference")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import registry  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "coral_tpu")


def process_start() -> float:
    """Wall-clock time at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()


def resident_bytes() -> int:
    """The process's resident set now (``/proc/self/statm``)."""
    with open("/proc/self/statm") as fh:
        return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class PeakRss:
    """The process's peak resident set over the window alone: a thread
    reads the resident set every ``period`` seconds from the window's start
    to its end, so nothing of the set-up counts."""

    def __init__(self, period: float = 0.01):
        self.period = period
        self.peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)

    def _watch(self) -> None:
        while not self._stop.wait(self.period):
            self.peak = max(self.peak, resident_bytes())

    def start(self) -> None:
        self.peak = resident_bytes()
        self._thread.start()

    def stop(self) -> int:
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, resident_bytes())
        return self.peak


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def build_cfg(cli, overrides=None):
    """The port's ``Config`` as ``cli.reconstruct_mode`` builds it from
    the configuration's command-line options; returns (cfg, args)."""
    from coral_tpu_torch import cli as port_cli
    from coral_tpu_torch.config import DEFAULT_CONFIG

    argv = list(cli) + ["--lr_bam", "-", "--cnv_seed", "-", "--cn_seg", "-",
                        "--output_prefix", "-"]
    for k, v in (overrides or {}).items():
        argv += [k, v]
    args = port_cli.build_parser().parse_args(argv)
    cfg = DEFAULT_CONFIG.replace(
        bp=dataclasses.replace(DEFAULT_CONFIG.bp,
                               min_bp_cov_factor=args.min_bp_support,
                               nm_filter=args.filter_bp_by_edit_distance),
        cycles=dataclasses.replace(
            DEFAULT_CONFIG.cycles,
            alpha=args.cycle_decomp_alpha,
            time_limit_s=args.cycle_decomp_time_limit,
            threads=args.cycle_decomp_threads or -1,
            postprocess=bool(args.postprocess_greedy_sol),
        ),
        engine=dataclasses.replace(
            DEFAULT_CONFIG.engine, engine=args.engine,
            cn_engine=args.cn_engine),
    )
    return cfg, args


def reconstruct_once(bam, seeds, cns, prefix, cfg, device, cycles):
    """One sample, as ``python -m coral_tpu_torch reconstruct`` runs it;
    returns the CN of every edge at full precision."""
    from coral_tpu_torch import reconstruct as recmod

    rec = recmod.reconstruct_graphs(bam, seeds, cns, prefix, cfg=cfg,
                                    device=device)
    if cycles:
        recmod.reconstruct_cycles(rec, prefix)
    rec.bam.close()
    cn = [{"sequence": [float(e.cn) for e in g.sequence_edges],
           "concordant": [float(e.cn) for e in g.concordant_edges],
           "discordant": [float(e.cn) for e in g.discordant_edges]}
          for g in rec.graphs]
    return cn


def sync(device) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


class TraceReading:
    """What a per-layer metric reads: the samples in the traced window,
    the tracer's spans and counters, marks the readers set at the window's
    start, and the device trace (None where no card was traced)."""

    def __init__(self, tracer, t0, t1, samples, device):
        self.tracer, self.t0, self.t1 = tracer, t0, t1
        self.samples = samples
        self.records = 0
        self.device = device
        self.counts = tracer.counts if tracer else {}
        self.marks = {}

    def per_sample(self, span):
        if not self.samples:
            return None
        return self.tracer.seconds(span, self.t0, self.t1) / self.samples


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def run_cell(c, seed, seconds, trace, overrides=None, log=sys.stderr):
    """Set up, run the window, check; returns the result dict, or None when
    the process holds a forbidden module after the window.  ``overrides``
    adds command-line options to the configuration's (the CPU tests'
    ``--device cpu``)."""
    import torch

    import compare
    from outputs import gather

    with_cycles = "--skip_cycle_decomp" not in c.config["cli"]
    cfg, args = build_cfg(c.config["cli"], overrides)
    device = args.device
    work = tempfile.mkdtemp(prefix="coral-bench-", dir=os.environ.get("TMPDIR"))
    try:
        from coral_tpu_torch.tracing import setup_file_logging

        setup_file_logging(os.path.join(work, "infer_breakpoint_graph.log"))
        sample = write_in_child(c.mix, seed, os.path.join(work, "in"), "sample")
        # the warm-up reconstructs the sample itself once: every shape the
        # window uses is built and every module loaded before it starts
        reconstruct_once(sample.bam, sample.seeds, sample.cns,
                         os.path.join(work, "warm"), cfg, device, with_cycles)
        sync(device)

        readers = {m["name"]: registry.metric_reader(m["name"])
                   for m in c.per_layer} if trace else {}
        tracer = prof = None
        if trace:
            import spans

            tracer = spans.Tracer(sync_device=str(device).startswith("cuda"))
            tracer.install(readers.values())
            acts = [torch.profiler.ProfilerActivity.CPU]
            if str(device).startswith("cuda"):
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
        reading = TraceReading(tracer, 0.0, 0.0, 0, None)
        for r in readers.values():
            if hasattr(r, "begin"):
                r.begin(reading)

        gc.collect()
        if str(device).startswith("cuda"):
            torch.cuda.reset_peak_memory_stats()
        rss = PeakRss()
        if prof is not None:
            prof.start()
        rss.start()
        setup_s = time.time() - T_START
        cns_by_sample, failed = [], 0
        out_dir = os.path.join(work, "out")
        os.makedirs(out_dir)
        t0 = time.perf_counter()
        c0 = time.process_time()
        try:
            with (torch.profiler.record_function("span:window") if trace
                  else contextlib.nullcontext()):
                while True:
                    ts = time.perf_counter()
                    cs = time.process_time()
                    prefix = os.path.join(out_dir, f"s{len(cns_by_sample)}")
                    try:
                        cns_by_sample.append(reconstruct_once(
                            sample.bam, sample.seeds, sample.cns, prefix, cfg,
                            device, with_cycles))
                    except Exception:
                        traceback.print_exc(file=log)
                        cns_by_sample.append(None)
                        failed += 1
                    sync(device)
                    tg = time.perf_counter()
                    gc.collect()
                    te = time.perf_counter()
                    print(f"sample {len(cns_by_sample)}: at {ts - t0:.3f} s, "
                          f"{te - ts:.4f} s, of which gc {te - tg:.4f} s, "
                          f"cpu {time.process_time() - cs:.4f} s", file=log)
                    if te - t0 >= seconds:
                        break
            t1 = time.perf_counter()
            c1 = time.process_time()
            peak_rss = rss.stop()
            print(f"peak_rss: {peak_rss} B, sampled every {rss.period} s",
                  file=log)
            mem_peak = (torch.cuda.max_memory_allocated()
                        if str(device).startswith("cuda") else 0)
        finally:
            if prof is not None:
                prof.stop()
            if tracer is not None:
                tracer.uninstall()
        bad = forbidden_modules()
        if bad:
            print(f"modules of JAX or the JAX package loaded: {bad}", file=log)
            return None
        samples = len(cns_by_sample)
        print(f"window: {samples} samples in {t1 - t0:.4f} s, "
              f"{sample.n_records * samples / (t1 - t0):.4f} records/s, "
              f"cpu {c1 - c0:.4f} s", file=log)

        metrics = {}
        if trace:
            import devtrace

            dev = None
            if str(device).startswith("cuda"):
                path = os.path.join(work, "trace.json")
                prof.export_chrome_trace(path)
                dev = devtrace.read_chrome_trace(path)
                os.remove(path)
            reading.tracer, reading.t0, reading.t1 = tracer, t0, t1
            reading.samples, reading.device = samples, dev
            reading.records = sample.n_records * samples
            reading.counts = tracer.counts
            for m in c.per_layer:
                v = readers[m["name"]].read(reading)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            values = {"cpu_s_per_sample": (c1 - c0) / samples,
                      "peak_rss_gib": peak_rss / 2 ** 30,
                      "setup_s": setup_s}
            for m in c.end_to_end:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}

        # the check, once the window has closed and the device peak is read
        del prof
        gc.collect()
        ref = compare.Reference(c.mix, seed, sample.cns, sample.seeds,
                                c.config["constants"])
        lim = dict(c.config["check"])
        state = compare.new_state(with_cycles, ref.simple)
        for k, cn in enumerate(cns_by_sample):
            if cn is None:
                continue
            one = compare.new_state(with_cycles, ref.simple)
            compare.judge_sample(
                gather(os.path.join(out_dir, f"s{k}"), cn, with_cycles),
                ref, with_cycles, one)
            failed += not compare.verdict(one, lim)
            compare.merge(state, one)
        ok = compare.verdict(state, lim) and failed == 0 and samples > 0
        check = compare.summary(state, lim)
        check["failed_samples"] = {"value": failed, "limit": 0}
        for k, v in check.items():
            print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=log)

        result = {"correct": bool(ok), "attempted": samples, "failed": failed,
                  "metrics": metrics,
                  "device": device_info(device, mem_peak)}
        if trace and result["device"]["platform"] == "gpu" and dev is not None:
            result["device"]["busy_s"] = dev.busy_s
            result["device"]["window_s"] = dev.window_s
            result["breakdown"] = {"device_ops": dev.top_ops(),
                                   "idle_gaps": dev.idle_gaps()}
        result["check"] = {k: {"value": _num(v["value"]), "limit": v["limit"]}
                           for k, v in check.items()}
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def write_in_child(mix: dict, seed: int, out_dir: str, name: str):
    """The mix's sample, written by ``traffic/generator.py`` in a child
    process that this call waits for."""
    import generator

    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "traffic", "generator.py"),
         json.dumps(mix), str(seed), out_dir, name],
        capture_output=True, text=True, check=True)
    return generator.Sample(**json.loads(out.stdout.strip().splitlines()[-1]))


def _num(v):
    return v if isinstance(v, int) or math.isfinite(v) else str(v)


def device_info(device, mem_peak) -> dict:
    import torch

    if str(device).startswith("cuda"):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": int(mem_peak),
                "power_limit": power_limit()}
    return {"platform": "cpu", "kind": "cpu", "count": 0,
            "memory_peak_bytes": 0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = registry.load_spec(ROOT)
    c = registry.cell(spec, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        print(f"needs {c.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(c, args.seed, args.seconds, bool(args.trace))
    if result is None:
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
