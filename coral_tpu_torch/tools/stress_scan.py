#!/usr/bin/env python3
"""Large-BAM scan stress (the port's counterpart of
``tools/stress_scan.py``): a simulated sample's records replicated across
many chromosomes (the chromosome and read-name bytes patched in the
decompressed payload) into a multi-million-record coordinate-sorted BAM,
then the port's native scan, coverage queries and chimera collect over it,
timed.

    python -m coral_tpu_torch.tools.stress_scan [OUT] [N_CHROMS]
        [READ_LEN]

Host code only, on the port's own native library: it takes no
``--device``, needs no card and never creates a CUDA context.  Prints the
JAX tool's lines, then one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import struct
import time

CHR_LEN = 159_345_973


def build_big(out_dir, n_chroms=20, read_len=5000):
    """``n_chroms`` copies of the simulated sample's records, on
    chromosomes ``sq00``.. of chr7's length, written to
    ``out_dir/stress.bam`` byte for byte as ``tools/stress_scan.build_big``
    writes it.  Returns (path, records)."""
    from ..io.bgzf import BGZF_EOF, iter_blocks, write_bgzf
    from ..sim import simulate_ecdna

    if not 1 <= n_chroms <= 100:
        raise ValueError(f"n_chroms={n_chroms} outside 1..100")
    bam, _, _ = simulate_ecdna(
        out_dir, jitter=2, n_junction_reads=2000,
        bg_read_len=read_len, amp_read_len=read_len)
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

    # names of chr7's byte length, so that the SA tags' rnames patch in
    # place
    text = ("@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:sq{i:02d}\tLN:{CHR_LEN}\n"
        for i in range(n_chroms))).encode()
    header = b"BAM\x01" + struct.pack("<i", len(text)) + text \
        + struct.pack("<i", n_chroms)
    for i in range(n_chroms):
        nb = f"sq{i:02d}".encode() + b"\x00"
        header += struct.pack("<i", len(nb)) + nb + struct.pack("<i", CHR_LEN)

    big_path = os.path.join(out_dir, "stress.bam")
    with open(big_path, "wb") as fp:
        write_bgzf(fp, bytes(header), level=1)
        for c in range(n_chroms):
            n0, n1 = 48 + c // 10, 48 + c % 10
            for r in rel:
                struct.pack_into("<i", body, r + 4, c)   # ref_id
                body[r + 36] = n0                        # read-name prefix
                body[r + 37] = n1
            write_bgzf(fp, bytes(body).replace(b"chr7,",
                                               f"sq{c:02d},".encode()),
                       level=1)
        fp.write(BGZF_EOF)
    return big_path, len(rel) * n_chroms


def run(out, n_chroms=20, read_len=5000, log=print) -> dict:
    """Build the BAM under ``out``, scan it with the native backend, query
    coverage on every ``n_chroms // 7``-th chromosome and collect its
    chimeras; ``log`` gets the JAX tool's lines.  Returns the numbers;
    raises if the scan counts other than ``build_big``'s records."""
    from ..io.bam import BamFile
    from ..ops.chimera import collect_chimeras

    os.makedirs(out, exist_ok=True)
    t0 = time.time()
    path, n_expected = build_big(out, n_chroms=n_chroms, read_len=read_len)
    build_s = time.time() - t0
    size_mb = os.path.getsize(path) / 1e6
    log(f"built {n_expected} records in {build_s:.1f}s, {size_mb:.0f} MB")
    t0 = time.time()
    bam = BamFile(path, backend="native")
    scan_s = time.time() - t0
    if bam.n_records != n_expected:
        raise RuntimeError(f"scanned {bam.n_records} records, built "
                           f"{n_expected}")
    log(f"native scan: {scan_s:.2f}s = {bam.n_records / scan_s / 1e6:.2f} "
        f"Mrec/s = {size_mb / scan_s:.0f} MB/s compressed")
    t0 = time.time()
    total = 0
    for c in range(0, n_chroms, max(1, n_chroms // 7)):
        total += bam.coverage_sum(f"sq{c:02d}", 55_000_000, 55_400_000)
    query_s = time.time() - t0
    log(f"coverage queries: {query_s:.2f}s (sum {total})")
    t0 = time.time()
    _, chims, _ = collect_chimeras(bam)
    collect_s = time.time() - t0
    log(f"chimera collect: {collect_s:.2f}s ({len(chims)} chimeric reads)")
    bam.close()
    return {"records": bam.n_records, "records_built": n_expected,
            "bam_mb": size_mb, "build_s": build_s, "scan_s": scan_s,
            "scan_mrec_per_s": bam.n_records / scan_s / 1e6,
            "coverage_query_s": query_s, "coverage_sum": int(total),
            "chimera_collect_s": collect_s, "chimeric_reads": len(chims)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default="stress_out")
    ap.add_argument("n_chroms", nargs="?", type=int, default=20)
    ap.add_argument("read_len", nargs="?", type=int, default=5000)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.out, args.n_chroms, args.read_len)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
