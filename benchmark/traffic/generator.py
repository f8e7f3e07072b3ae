"""The sample stream's one generator: a long-read sample made from a traffic
mix's parameters and a seed.

A mix (``benchmark/traffic/<name>.json``) describes one amplicon on one
chromosome of hg38, inside a domain of background reads, in one of two
shapes that :func:`shape` reads into one form:

* the one-segment circle: ``amp`` (half-open) at ``amp_extra_cov`` and
  ``n_junction_reads`` split reads across the junction from its last base
  back to its first (the canonical single-cycle ecDNA);
* the general amplicon: ``segments``, each ``{"at": [start, end),
  "extra_cov": x, "amplified": bool}``; ``junctions``, each ``{"ends":
  [[p1, o1], [p2, o2]], "reads": n, "form": "split" | "deletion"}``; and
  optionally ``spanning_reads``, each ``{"len": L, "starts": [...]}``.

A junction end ``[p, "+"]`` is the right end of the piece whose last base
is ``p``, ``[p, "-"]`` the left end of the piece whose first base is ``p``,
as CoRAL's breakpoint graph names its nodes.  A read crosses a junction
out of the piece at end 1 into the piece at end 2, so ``+ -`` runs on in
the reference's direction, ``- +`` runs against it, and ``+ +`` and ``- -``
fold back; every pair is admitted.

What is planted:

* background reads of ``read_len`` tiled at ``bg_cov`` over ``domain``,
  read ``k`` starting at ``start + k * read_len // bg_cov``;
* each segment tiled the same way at its extra coverage, reads lying
  wholly inside it (a segment shorter than a read gets none: its extra
  coverage, if any, comes from spanning reads);
* for each ``split`` junction, reads of ``read_len`` across it: a primary
  alignment of ``f1`` bases reaching end 1 (jittered by ``j1``) and a
  supplementary of ``read_len - f1`` bases leaving end 2 (jittered by
  ``j2``), on the strands the ends' orientations give, with ``SA:Z`` tags
  naming each other and only M and S in their CIGARs; ``j1, j2`` uniform
  in ``[-jitter, jitter]`` and ``f1`` uniform in ``[min_flank, read_len -
  min_flank]``;
* for each ``deletion`` junction (``[p1, "+"]`` and ``[p2, "-"]``, p1 <
  p2), reads of ``read_len`` aligned ``f1``M ``L``D ``read_len - f1``M
  with the deletion over ``[p1 + j1, p2 + j2)``: CoRAL's small-deletion
  rule takes the first block's (exclusive) end as the ``+`` end, so the
  skipped piece ``[p1 + 1, p2 - 1]`` sits between the two ends;
* each spanning read, of its own length at its stated start.

Every record carries its SEQ and QUAL (random bases and Phred qualities of
mean ``qual_mean`` and spread ``qual_sd``), a 36-letter UUID read name,
``NM:i`` and, on split reads, ``SA:Z``.  Tiled and spanning reads align as
the unit ``indel_unit[0]``M 1I ``indel_unit[1]``M 1D repeated, then M to
their end, so they carry one insertion and one deletion every
``indel_unit[0] + indel_unit[1] + 1`` bases.

The CN segments (``.cns``) cut the domain into rows of ``cn_row_bp``, with
one amplified row from ``cn_pad[0]`` before the first amplified segment to
``cn_pad[1]`` after the last, at their length-weighted extra coverage; the
seed interval runs from the first amplified base to the last.  The seed
reaches the junction geometry, the names, SEQ and QUAL, so two seeds give
two samples of one size.  A one-segment mix and the general mix of the
same circle give the same bytes.

Imports nothing of the program: the BGZF and BAM encoding below follow the
SAM specification (section 4), written for these record shapes.
"""
from __future__ import annotations

import json
import math
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List

import numpy as np

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
BLOCK_PAYLOAD = 65280          # htslib's uncompressed block size
CHUNK_READS = 2048             # tiled reads encoded at a time
_REC_HEAD = struct.Struct("<iiBBHHHiiii")
_NIBBLES = np.array([1, 2, 4, 8], np.uint8)      # A C G T in "=ACMGRSVTWYHKDBN"
_HEX = np.frombuffer(b"0123456789abcdef", np.uint8)
NAME_LEN = 36
M, I, D, S = 0, 1, 2, 4

# hg38 primary assembly, the BAM header's reference sequences
HG38 = {
    "chr1": 248956422, "chr2": 242193529, "chr3": 198295559,
    "chr4": 190214555, "chr5": 181538259, "chr6": 170805979,
    "chr7": 159345973, "chr8": 145138636, "chr9": 138394717,
    "chr10": 133797422, "chr11": 135086622, "chr12": 133275309,
    "chr13": 114364328, "chr14": 107043718, "chr15": 101991189,
    "chr16": 90338345, "chr17": 83257441, "chr18": 80373285,
    "chr19": 58617616, "chr20": 64444167, "chr21": 46709983,
    "chr22": 50818468, "chrX": 156040895, "chrY": 57227415,
}

TRAFFIC_DIR = os.path.dirname(os.path.abspath(__file__))


def load_mix(name: str) -> dict:
    """The mix's parameters from ``traffic/<name>.json``."""
    with open(os.path.join(TRAFFIC_DIR, f"{name}.json")) as fh:
        return json.load(fh)


def rng(seed: int, stream: int) -> np.random.Generator:
    """One of the seed's independent streams (any whole seed)."""
    return np.random.default_rng([seed % 2 ** 64, stream])


# -- what is planted --------------------------------------------------------

ORIENTATIONS = ("+", "-")
FORMS = ("split", "deletion")


def shape(p: dict) -> dict:
    """The mix in the general form, checked: ``segments``, ``junctions``,
    ``spanning_reads`` and ``circles`` (the planted circles as cycle-file
    segment lists, 1-based over ``segments``).  A one-segment mix becomes
    one amplified segment and one split junction from its last base back to
    its first."""
    if "segments" in p:
        q = dict(p, spanning_reads=p.get("spanning_reads", []),
                 circles=p.get("circles", []))
    else:
        a0, a1 = p["amp"]
        q = {k: v for k, v in p.items()
             if k not in ("amp", "amp_extra_cov", "n_junction_reads")}
        q.update(segments=[{"at": [a0, a1], "extra_cov": p["amp_extra_cov"],
                            "amplified": True}],
                 junctions=[{"ends": [[a1 - 1, "+"], [a0, "-"]],
                             "reads": p["n_junction_reads"], "form": "split"}],
                 spanning_reads=[], circles=["1+"])
    _check(q)
    return q


def _check(q: dict) -> None:
    d0, d1 = q["domain"]
    if not any(sg["amplified"] for sg in q["segments"]):
        raise ValueError("a mix needs an amplified segment")
    for sg in q["segments"]:
        s0, s1 = sg["at"]
        cov = sg["extra_cov"]
        if not (d0 <= s0 < s1 <= d1) or int(cov) != cov or cov < 0:
            raise ValueError(f"segment {sg} lies outside the domain or has "
                             f"no whole extra coverage")
    for jn in q["junctions"]:
        (p1, o1), (p2, o2) = jn["ends"]
        if o1 not in ORIENTATIONS or o2 not in ORIENTATIONS \
                or jn["form"] not in FORMS or jn["reads"] < 0:
            raise ValueError(f"junction {jn}: ends take + or -, form one of "
                             f"{FORMS}")
        if abs(p1 - p2) <= 2 * q["jitter"] + 1:
            raise ValueError(f"junction {jn}: its ends lie within the jitter")
        if jn["form"] == "deletion" and not (o1 == "+" and o2 == "-"
                                             and p1 < p2):
            raise ValueError(f"junction {jn}: a deletion runs from [p1, +] "
                             f"to [p2, -] with p1 < p2")
        if not all(d0 <= x < d1 for x in (p1, p2)):
            raise ValueError(f"junction {jn} lies outside the domain")
    for sp in q["spanning_reads"]:
        if any(not (d0 <= x and x + sp["len"] <= d1) for x in sp["starts"]):
            raise ValueError(f"spanning reads {sp} leave the domain")


def tiled_starts(start: int, stop: int, read_len: int, cov: int) -> np.ndarray:
    """Starts of reads of ``read_len`` tiled at ``cov`` over [start, stop)."""
    if cov <= 0 or stop - start < read_len:
        return np.zeros(0, np.int64)
    n = ((stop - read_len - start) * cov) // read_len + 1
    return start + (np.arange(n, dtype=np.int64) * read_len) // cov


def tiled_reads(p: dict) -> np.ndarray:
    """Starts of every tiled read, background then each segment, sorted."""
    q = shape(p)
    d0, d1 = q["domain"]
    pos = [tiled_starts(d0, d1, q["read_len"], q["bg_cov"])]
    pos += [tiled_starts(sg["at"][0], sg["at"][1], q["read_len"],
                         int(sg["extra_cov"])) for sg in q["segments"]]
    return np.sort(np.concatenate(pos), kind="stable")


def junction_reads(p: dict, seed: int):
    """[(j1, j2, f1)] of every junction's reads, as the seed draws them,
    junction by junction."""
    q = shape(p)
    g = rng(seed, 1)
    j = q["jitter"]
    out = []
    for jn in q["junctions"]:
        n = jn["reads"]
        j1 = g.integers(-j, j + 1, n)
        j2 = g.integers(-j, j + 1, n)
        f1 = g.integers(q["min_flank"], q["read_len"] - q["min_flank"] + 1, n)
        out.append((j1, j2, f1))
    return out


def split_alignments(ends, a: int, b: int, j1: int, j2: int):
    """The two alignments of a read across a split junction, each as
    (leftmost position, strand, CIGAR as (op, length)): ``a`` bases reach
    end 1 moved by ``j1``, then ``b`` bases leave end 2 moved by ``j2``."""
    (p1, o1), (p2, o2) = ends
    e1, e2 = p1 + j1, p2 + j2
    first = ((e1 - a + 1, "+", [(M, a), (S, b)]) if o1 == "+"
             else (e1, "-", [(S, b), (M, a)]))
    second = ((e2, "+", [(S, a), (M, b)]) if o2 == "-"
              else (e2 - b + 1, "-", [(M, b), (S, a)]))
    return first, second


def tiled_cigar(p: dict, length: int = 0):
    """The CIGAR of a tiled or spanning read of ``length`` (``read_len`` by
    default) as (op, length) and its deletions' offsets from the read's
    start (reference and query spans are both ``length``)."""
    a, b = p["indel_unit"]
    unit = a + b + 1
    n_units, rest = divmod(length or p["read_len"], unit)
    ops = [(M, a), (I, 1), (M, b), (D, 1)] * n_units + [(M, rest)] * bool(rest)
    return ops, a + b + unit * np.arange(n_units, dtype=np.int64)


def cn_rows(p: dict):
    """(start, end, amplified) rows of the CN segment file, half-open."""
    q = shape(p)
    d0, d1 = q["domain"]
    a0, a1 = amplified_span(q)
    r0, r1 = a0 - q["cn_pad"][0], a1 + q["cn_pad"][1]
    step = q["cn_row_bp"]
    rows = [(s, min(s + step, r0), False) for s in range(d0, r0, step)]
    rows.append((r0, r1, True))
    rows += [(s, min(s + step, d1), False) for s in range(r1, d1, step)]
    return rows


def amplified_span(q: dict):
    """[first amplified base, last amplified base + 1)."""
    amp = [sg["at"] for sg in q["segments"] if sg["amplified"]]
    return min(a[0] for a in amp), max(a[1] for a in amp)


def amplified_extra_cov(q: dict) -> int:
    """The amplified segments' extra coverage, weighted by their length."""
    amp = [sg for sg in q["segments"] if sg["amplified"]]
    bases = sum(sg["extra_cov"] * (sg["at"][1] - sg["at"][0]) for sg in amp)
    return int(round(bases / sum(sg["at"][1] - sg["at"][0] for sg in amp)))


# -- BGZF -------------------------------------------------------------------

def _block(data) -> bytes:
    co = zlib.compressobj(1, zlib.DEFLATED, -15)
    comp = co.compress(data) + co.flush()
    head = struct.pack("<BBBBIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
                       0x42, 0x43, 2, len(comp) + 25)
    return head + comp + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF,
                                     len(data))


class BgzfWriter:
    """Cuts the payload into BGZF blocks and compresses them on a thread
    pool (zlib frees the interpreter lock)."""

    def __init__(self, fp, pool):
        self.fp, self.pool, self.pending = fp, pool, b""

    def write(self, data: bytes, final: bool = False) -> None:
        buf = self.pending + data
        full = len(buf) if final else len(buf) - len(buf) % BLOCK_PAYLOAD
        view = memoryview(buf)
        parts = [view[i:i + BLOCK_PAYLOAD] for i in range(0, full, BLOCK_PAYLOAD)]
        for blk in self.pool.map(_block, parts):
            self.fp.write(blk)
        self.pending = bytes(view[full:])

    def close(self) -> None:
        self.write(b"", final=True)
        self.fp.write(BGZF_EOF)


# -- records ----------------------------------------------------------------

def reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """The BAI bin of [beg, end) (SAM specification, section 5.3)."""
    e = end - 1
    out = np.zeros(len(beg), np.int64)
    done = np.zeros(len(beg), bool)
    for shift, off in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((beg >> shift) == (e >> shift))
        out[hit] = off + (beg[hit] >> shift)
        done |= hit
    return out


def uuid_names(g: np.random.Generator, n: int) -> np.ndarray:
    """(n, 36) uint8: random UUID-shaped read names."""
    hexed = _HEX[g.integers(0, 16, (n, 32), dtype=np.uint8)]
    out = np.full((n, NAME_LEN), ord("-"), np.uint8)
    for dst, src in ((0, 0), (9, 8), (14, 12), (19, 16), (24, 20)):
        w = {0: 8, 24: 12}.get(dst, 4)
        out[:, dst:dst + w] = hexed[:, src:src + w]
    return out


class Pools:
    """Random packed bases and qualities that reads take windows of."""

    def __init__(self, g: np.random.Generator, p: dict):
        n = 1 << 22
        codes = _NIBBLES[g.integers(0, 4, (n, 2), dtype=np.uint8)]
        self.seq = (codes[:, 0] << 4) | codes[:, 1]
        q = np.rint(g.normal(p["qual_mean"], p["qual_sd"], 2 * n))
        self.qual = np.clip(q, 2, 50).astype(np.uint8)
        self.g = g

    def take(self, pool: np.ndarray, n: int, width: int) -> np.ndarray:
        at = self.g.integers(0, len(pool) - width, n)
        return np.lib.stride_tricks.sliding_window_view(pool, width)[at]


def tiled_rows(pos, chrom_id, cigar, p, pools, names) -> np.ndarray:
    """The tiled reads at ``pos`` as rows of one uint8 array."""
    n, rlen = len(pos), p["read_len"]
    cig = b"".join(struct.pack("<I", (ln << 4) | op) for op, ln in cigar)
    seq_len = (rlen + 1) // 2
    n_del = sum(ln for op, ln in cigar if op in (I, D))
    tags = b"NMi" + struct.pack("<i", n_del)
    width = 36 + NAME_LEN + 1 + len(cig) + seq_len + rlen + len(tags)
    head = np.zeros(n, dtype=np.dtype([
        ("size", "<i4"), ("ref", "<i4"), ("pos", "<i4"), ("lname", "u1"),
        ("mapq", "u1"), ("bin", "<u2"), ("ncig", "<u2"), ("flag", "<u2"),
        ("lseq", "<i4"), ("mref", "<i4"), ("mpos", "<i4"), ("tlen", "<i4")]))
    head["size"] = width - 4
    head["ref"] = chrom_id
    head["pos"] = pos
    head["lname"] = NAME_LEN + 1
    head["mapq"] = 60
    head["bin"] = reg2bin(pos, pos + rlen)
    head["ncig"] = len(cigar)
    head["lseq"] = rlen
    head["mref"] = -1
    head["mpos"] = -1
    rows = np.empty((n, width), np.uint8)
    rows[:, :36] = head.view(np.uint8).reshape(n, 36)
    c = 36
    rows[:, c:c + NAME_LEN] = names
    rows[:, c + NAME_LEN] = 0
    c += NAME_LEN + 1
    rows[:, c:c + len(cig)] = np.frombuffer(cig, np.uint8)
    c += len(cig)
    rows[:, c:c + seq_len] = pools.take(pools.seq, n, seq_len)
    c += seq_len
    rows[:, c:c + rlen] = pools.take(pools.qual, n, rlen)
    c += rlen
    rows[:, c:] = np.frombuffer(tags, np.uint8)
    return rows


def split_record(name: bytes, flag: int, chrom_id: int, pos: int, cigar,
                 seq: bytes, qual: bytes, tags: bytes) -> bytes:
    """One record outside the tiling (``cigar`` as (op, length))."""
    ref_len = sum(ln for op, ln in cigar if op in (M, D))
    rlen = len(qual)
    binv = int(reg2bin(np.array([pos]), np.array([pos + ref_len]))[0])
    body = _REC_HEAD.pack(chrom_id, pos, len(name) + 1, 60, binv, len(cigar),
                          flag, rlen, -1, -1, 0) + name + b"\0"
    body += b"".join(struct.pack("<I", (ln << 4) | op) for op, ln in cigar)
    body += seq + qual + tags
    return struct.pack("<i", len(body)) + body


def _cigar_text(cigar) -> str:
    return "".join(f"{ln}{'MIDNS'[op]}" for op, ln in cigar)


def _nm(n: int) -> bytes:
    return b"NMi" + struct.pack("<i", n)


def junction_records(p: dict, seed: int, chrom_id: int, pools, names):
    """(pos, bytes) of every junction record, sorted by position."""
    q = shape(p)
    chrom, rlen = q["chrom"], q["read_len"]
    out, k = [], 0
    for jn, (j1, j2, f1) in zip(q["junctions"], junction_reads(q, seed)):
        n = len(f1)
        seqs = pools.take(pools.seq, n, (rlen + 1) // 2)
        quals = pools.take(pools.qual, n, rlen)
        for i in range(n):
            a, b = int(f1[i]), rlen - int(f1[i])
            name = names[k + i].tobytes()
            seq, qual = seqs[i].tobytes(), quals[i].tobytes()
            if jn["form"] == "deletion":
                start = jn["ends"][0][0] + int(j1[i])
                gap = jn["ends"][1][0] + int(j2[i]) - start
                out.append((start - a, split_record(
                    name, 0, chrom_id, start - a, [(M, a), (D, gap), (M, b)],
                    seq, qual, _nm(gap))))
                continue
            alns = split_alignments(jn["ends"], a, b, int(j1[i]), int(j2[i]))
            nms = (round(0.05 * a), round(0.05 * b))
            sas = [f"{chrom},{x + 1},{st},{_cigar_text(cg)},60,{nm};".encode()
                   for (x, st, cg), nm in zip(alns, nms)]
            for w, ((x, st, cg), nm) in enumerate(zip(alns, nms)):
                flag = (0x800 if w else 0) | (0x10 if st == "-" else 0)
                out.append((x, split_record(
                    name, flag, chrom_id, x, cg, seq, qual,
                    _nm(nm) + b"SAZ" + sas[1 - w] + b"\0")))
        k += n
    out.sort(key=lambda x: x[0])
    return out


def spanning_records(p: dict, chrom_id: int, pools, names):
    """(pos, bytes) of every spanning read, in the mix's order."""
    q = shape(p)
    out, k = [], 0
    for sp in q["spanning_reads"]:
        n, ln = len(sp["starts"]), sp["len"]
        cigar, _ = tiled_cigar(q, ln)
        seqs = pools.take(pools.seq, n, (ln + 1) // 2)
        quals = pools.take(pools.qual, n, ln)
        tags = _nm(sum(c for op, c in cigar if op in (I, D)))
        for i, x in enumerate(sp["starts"]):
            out.append((x, split_record(
                names[k + i].tobytes(), 0, chrom_id, x, cigar,
                seqs[i].tobytes(), quals[i].tobytes(), tags)))
        k += n
    return out


@dataclass
class Sample:
    bam: str
    cns: str
    seeds: str
    n_records: int
    chroms: List[str]


def write_sample(out_dir: str, p: dict, seed: int, name: str = "sample",
                 threads: int = 8) -> Sample:
    """The mix's sample under ``out_dir``: ``<name>.bam``, ``<name>.cns``,
    ``<name>_seeds.bed``."""
    os.makedirs(out_dir, exist_ok=True)
    q = shape(p)
    chrom = q["chrom"]
    refs = list(HG38)
    chrom_id = refs.index(chrom)
    g = rng(seed, 2)
    pools = Pools(g, q)
    pos = tiled_reads(q)
    cigar, _ = tiled_cigar(q)
    n_jx = sum(jn["reads"] for jn in q["junctions"])
    n_span = sum(len(sp["starts"]) for sp in q["spanning_reads"])
    names = uuid_names(g, len(pos) + n_jx + n_span)
    jx = junction_records(q, seed, chrom_id, pools, names[len(pos):])
    jx += spanning_records(q, chrom_id, pools, names[len(pos) + n_jx:])
    jx.sort(key=lambda x: x[0])
    jx_at = np.searchsorted(pos, [x[0] for x in jx], side="right")

    text = ("@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{c}\tLN:{HG38[c]}\n" for c in refs)).encode()
    header = b"BAM\x01" + struct.pack("<i", len(text)) + text \
        + struct.pack("<i", len(refs))
    for c in refs:
        header += struct.pack("<i", len(c) + 1) + c.encode() + b"\0" \
            + struct.pack("<i", HG38[c])

    bam = os.path.join(out_dir, f"{name}.bam")
    k = 0                                     # next junction record
    with open(bam, "wb") as fp, ThreadPoolExecutor(threads) as pool:
        w = BgzfWriter(fp, pool)
        w.write(header)
        for s in range(0, len(pos), CHUNK_READS):
            e = min(s + CHUNK_READS, len(pos))
            rows = tiled_rows(pos[s:e], chrom_id, cigar, q, pools, names[s:e])
            pieces, at = [], s
            while k < len(jx) and (jx_at[k] < e or e == len(pos)):
                cut = int(jx_at[k])
                pieces.append(rows[at - s:cut - s].tobytes())
                pieces.append(jx[k][1])
                at, k = cut, k + 1
            pieces.append(rows[at - s:].tobytes())
            w.write(b"".join(pieces))
        w.close()

    cns = os.path.join(out_dir, f"{name}.cns")
    bg, extra = q["bg_cov"], amplified_extra_cov(q)
    amp_log2 = math.log2((bg + extra) / bg)
    with open(cns, "w") as fp:
        fp.write("chromosome\tstart\tend\tgene\tlog2\tdepth\n")
        for s, e, amp in cn_rows(q):
            fp.write(f"{chrom}\t{s}\t{e}\t-\t{amp_log2 if amp else 0.0}"
                     f"\t{bg + extra if amp else bg}\n")
    seeds = os.path.join(out_dir, f"{name}_seeds.bed")
    a0, a1 = amplified_span(q)
    with open(seeds, "w") as fp:
        fp.write(f"{chrom}\t{a0}\t{a1 - 1}\n")
    return Sample(bam, cns, seeds, len(pos) + len(jx), [chrom])


def main(argv=None) -> int:
    """``generator.py MIX_JSON SEED OUT_DIR NAME``: writes the sample and
    prints it as one JSON object (run in a child process, so that the
    writer's memory never counts in the caller's)."""
    import sys

    mix, seed, out_dir, name = (argv or sys.argv[1:])
    s = write_sample(out_dir, json.loads(mix), int(seed), name)
    print(json.dumps(s.__dict__))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
