#!/usr/bin/env python3
"""A/B of three routes over the same pairs (the port's counterpart of
``tools/bench_v3_ab.py``): the v2 fused scorer (16 B a pair,
``make_batch_scorer(engine="cuda2")``, K6), the v3 fused scorer (12 B a
pair, ``engine="cuda"``, K2) and the v3 hit mask (K1, what ``reconstruct
--engine cuda`` runs), on ``synth_scoring_batch(2^21)`` packed by the
native packers.

    python -m coral_tpu_torch.tools.bench_v3_ab [--device cuda|cpu]

Prints one JSON object: the packers' host ms (``pack2_ms``,
``pack3_ms``), ``support_identical`` (v2 and v3 support equal),
``support_sum``, ``hitmask_sum``, and each route's ``*_reads_per_s`` and
``*_GBps`` (bytes moved a pair: 16, 12, and 12 read + 1 written for
the hit mask, over the median CUDA-event time of one call
after an L2 flush).  With ``--device cpu`` the same routes run through the
kernels' plain versions (engine ``torch``) and the times are host times.
"""
from __future__ import annotations

import argparse
import json
import time

CUTOFF, MIN_MAPQ, GAP = 100, 20, 100.0


def _routes(ic, is_, ie, engine, dev):
    """(build_tables, score2, score3, hitmask) of ``engine``: ``cuda``
    the batch scorers of K6 and K2 and the wrapper of K1; ``torch`` the
    kernels' plain versions beside the same int64 coverage."""
    import torch

    from ..ops import kernels
    from ..ops.scoring import coverage_prefix_eval, make_batch_scorer

    if engine == "cuda":
        if dev.type != "cuda":
            raise ValueError(f"engine 'cuda' needs a CUDA device, not {dev}")
        build, score2 = make_batch_scorer(ic, is_, ie, "cuda2", device=dev)
        _, score3 = make_batch_scorer(ic, is_, ie, "cuda", device=dev)
        return build, score2, score3, \
            lambda *c: kernels.pair3_hitmask(*c, CUTOFF, GAP)
    if engine != "torch":
        raise ValueError(f"unknown engine {engine!r} (torch or cuda)")
    # the scorer of the 14 unpacked columns, for its tables and coverage
    build, _ = make_batch_scorer(ic, is_, ie, "torch", device=dev)
    lo = torch.as_tensor(is_, dtype=torch.int64, device=dev)
    hi = torch.as_tensor(ie, dtype=torch.int64, device=dev)
    n_int = len(ic)

    def cov(tables):
        return coverage_prefix_eval(tables, hi) \
            - coverage_prefix_eval(tables, lo)

    return (build,
            lambda t, *c: (kernels.pair2_support_torch(
                *c, n_int, CUTOFF, MIN_MAPQ, GAP), cov(t)),
            lambda t, *c: (kernels.pair3_support_torch(
                *c, n_int, CUTOFF, GAP), cov(t)),
            lambda *c: kernels.pair3_hitmask_torch(*c, CUTOFF, GAP))


def run(n_reads=1 << 21, *, engine="cuda", device="cuda") -> dict:
    """The three routes on ``synth_scoring_batch(n_reads)``; the report."""
    import torch

    from ..device import resolve_device
    from ..native.bamcore import pack_pairs2, pack_pairs3
    from .bench_common import synth_alignment_table, synth_scoring_batch, \
        time_ms

    dev = resolve_device(device)
    starts, ends, cols, ic, is_, ie = synth_scoring_batch(n_reads)
    aln = synth_alignment_table(cols)
    out = {}
    t0 = time.perf_counter()
    p2 = pack_pairs2(*aln, ic, is_, ie)
    out["pack2_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
    t0 = time.perf_counter()
    p3 = pack_pairs3(*aln, ic, is_, ie, min_mapq=MIN_MAPQ)
    out["pack3_ms"] = round((time.perf_counter() - t0) * 1e3, 1)

    build, score2, score3, hitmask = _routes(ic, is_, ie, engine, dev)
    d2 = [torch.from_numpy(c).to(dev) for c in p2]
    d3 = [torch.from_numpy(c).to(dev) for c in p3]
    tables = build(starts, ends)
    s2 = score2(tables, *d2)[0].cpu().numpy()
    s3 = score3(tables, *d3)[0].cpu().numpy()
    out["support_identical"] = bool((s2 == s3).all())
    out["support_sum"] = int(s3.sum())
    out["hitmask_sum"] = int(hitmask(*d3).sum())

    t2 = time_ms(lambda: score2(tables, *d2), dev) / 1e3
    t3 = time_ms(lambda: score3(tables, *d3), dev) / 1e3
    thm = time_ms(lambda: hitmask(*d3), dev) / 1e3
    out["fused_v2_reads_per_s"] = round(n_reads / t2)
    out["fused_v3_reads_per_s"] = round(n_reads / t3)
    out["hitmask_v3_reads_per_s"] = round(n_reads / thm)
    out["fused_v2_GBps"] = round(n_reads * 16 / t2 / 1e9, 1)
    out["fused_v3_GBps"] = round(n_reads * 12 / t3 / 1e9, 1)
    # K1 writes a byte a pair where the TPU kernel wrote an int32
    out["hitmask_v3_GBps"] = round(n_reads * 13 / thm / 1e9, 1)
    return out


def main(argv=None) -> int:
    from ..device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    engine = "cuda" if dev.type == "cuda" else "torch"
    print(json.dumps(run(engine=engine, device=dev), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
