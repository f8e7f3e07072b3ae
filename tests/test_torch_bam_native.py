"""The port's native BAM core held by its outputs: its scan's record
table and the chimeras its SA parse assembles, and its region decodes,
against the reference package's pure-Python reader at 1, 2 and 8
threads; the sums and gap searches that the scan's columns answer
against the reference package's readers and the port's own full decode.

The fixture's payload is rewritten as BGZF members of BLOCK bytes, so
records straddle members and windows, and a contig spans more than two
windows at 8 threads.
"""
import gzip
import os
import random
import struct

import numpy as np
import pytest

from coral_tpu.io.bam import BamFile as RefBam
from coral_tpu.io.bam import _native_available as _ref_native_available
from coral_tpu_torch.io.bam import FLAG_EXCLUDE_ALL
from coral_tpu_torch.io.bam import BamFile
from coral_tpu_torch.io.bam import _native_available
from coral_tpu_torch.io.bamwrite import BamRecord, write_bam
from coral_tpu_torch.io.bgzf import BGZF_EOF, compress_block

REFS = [("chr1", 2_000_000), ("chr2", 2_000_000)]
BLOCK = 509               # payload bytes a BGZF member
NTHREADS = [1, 2, 8]
# a decode reads 16 members a thread in a window: 128 at 8 threads
WINDOW_MAX = 16 * max(NTHREADS)
EDGES = {
    "mid_block": ("chr1", 200_000, 700_000),
    "last_record": ("chr2", 900_000, 2_000_000),
    "one_record": ("chr1", 1_499_000, 1_600_000),
    "empty": ("chr1", 1_900_000, 1_950_000),
    "few_members": ("chr1", 1_799_000, 1_810_000),
}


def _fixture(tmp_path, n=600, seed=21):
    """Records of 50-3,000 bases with random qualities, deletions, clips
    and flags; lone records far out on chr1 and at the end of chr2; the
    payload rewritten as members of BLOCK bytes."""
    rng = random.Random(seed)
    qrng = np.random.default_rng(seed)
    recs = []

    def add(name, flag, ref, pos, mapq, cigar, qlen):
        quals = qrng.integers(0, 60, qlen, dtype=np.uint8).tobytes()
        recs.append(BamRecord(name, flag, ref, pos, mapq, cigar,
                              quals=quals, tags={"NM": rng.randrange(50)}))

    for i in range(n):
        mlen = rng.randrange(50, 3000)
        style = rng.random()
        if style < 0.3:
            clip = rng.randrange(1, 500)
            cigar, qlen = f"{clip}S{mlen}M", clip + mlen
        elif style < 0.6:
            tail = rng.randrange(50, 500)
            cigar = f"{mlen}M{rng.randrange(1, 3000)}D{tail}M"
            qlen = mlen + tail
        else:
            cigar, qlen = f"{mlen}M", mlen
        add(f"p{i:05d}", rng.choice([0, 0, 0, 16, 0x100, 0x800]),
            rng.choice(["chr1", "chr2"]), rng.randrange(0, 1_000_000),
            rng.randrange(0, 61), cigar, qlen)
    add("lone", 0, "chr1", 1_500_000, 60, "100M", 100)
    for k in range(3):
        add(f"few{k}", 0, "chr1", 1_800_000 + 100 * k, 60, "150M", 150)
    add("last", 0, "chr2", 1_500_000, 60, "3000M", 3000)
    # largest gaps of exactly 600 (a smaller one beside it), 700 across an
    # N, and 0 across an insertion
    add("gap600", 0, "chr2", 1_600_000, 60, "100M600D100M5D100M", 300)
    add("gap700n", 0, "chr2", 1_600_500, 60, "100M700N100M", 200)
    add("gap0", 0, "chr2", 1_601_000, 60, "100M10I100M", 210)
    recs += _split_reads(random.Random(seed + 1))
    src = str(tmp_path / "src.bam")
    write_bam(src, REFS, recs)
    payload = gzip.decompress(open(src, "rb").read())
    p = str(tmp_path / "small_blocks.bam")
    with open(p, "wb") as fp:
        for i in range(0, len(payload), BLOCK):
            fp.write(compress_block(payload[i:i + BLOCK], level=1))
        fp.write(BGZF_EOF)
    return p


def _split_reads(rng, n=40):
    """Split reads below 1 Mb: each a primary and one or two supplementary
    records whose SA tags list the read's other alignments, on either
    strand, with clips at either end or both, deletions and insertions;
    and five odd ones: a primary without an SA tag, an entry without a
    clip (the read keeps no alignment), no primary (the read is dropped),
    a tag without its last ';' and a one-base alignment (per-base NM
    infinite)."""
    out = []

    def read(name, parts, primary=True, sa_of=None):
        """parts: (query start, query end, read length, strand, chrom,
        pos, middle op) of each alignment, the first the primary."""
        cigars = []
        for qa, qb, rl, strand, _, _, mid in parts:
            m = qb - qa
            core = f"{m}M"
            if mid == "D":
                core = f"{m // 2}M{rng.randrange(1, 900)}D{m - m // 2}M"
            elif mid == "I":
                core = f"{m // 2}M{m // 4}I{m - m // 2 - m // 4}M"
            left, right = (qa, rl - qb) if strand == "+" else (rl - qb, qa)
            cigars.append((f"{left}S" if left else "") + core
                          + (f"{right}S" if right else ""))
        entries = [f"{c},{p + 1},{s},{cig},{rng.randrange(61)},"
                   f"{rng.randrange(30)};"
                   for (_, _, _, s, c, p, _), cig in zip(parts, cigars)]
        for k, ((_, _, _, s, c, p, _), cig) in enumerate(zip(parts, cigars)):
            flag = (0 if k == 0 and primary else 0x800) | (16 * (s == "-"))
            sa = "".join(entries[:k] + entries[k + 1:])
            if sa_of is not None:
                sa = sa_of(k, sa)
            out.append(BamRecord(name, flag, c, p, rng.randrange(61), cig,
                                 tags={"NM": rng.randrange(50), "SA": sa}
                                 if sa else {"NM": rng.randrange(50)}))

    def alignments(rl, cuts):
        bounds = [0] + sorted(cuts) + [rl]
        return [(a, b, rl, rng.choice("+-"), rng.choice(["chr1", "chr2"]),
                 rng.randrange(0, 950_000), rng.choice(["", "", "D", "I"]))
                for a, b in zip(bounds, bounds[1:])]

    for i in range(n):
        rl = rng.randrange(400, 4000)
        read(f"s{i:03d}", alignments(
            rl, rng.sample(range(60, rl - 60), rng.choice([1, 2]))))
    read("nosa_primary", alignments(900, [450]),
         sa_of=lambda k, sa: sa if k else "")
    read("noclip", alignments(900, [450]),
         sa_of=lambda k, sa: sa + ("chr1,100001,+,300M,60,3;" if k else ""))
    read("noprimary", alignments(900, [300]), primary=False)
    read("nosemi", alignments(900, [300]), sa_of=lambda k, sa: sa[:-1])
    read("onebase", [(0, 899, 900, "+", "chr1", 600_000, ""),
                     (899, 900, 900, "+", "chr2", 700_000, "")])
    return out


def _native(path, nthreads):
    """The port's native BamFile, its region decodes run by a handle
    opened with ``nthreads`` (the table's arrays stay views of the first
    handle, which it keeps alive)."""
    from coral_tpu_torch.native import bamcore

    bam = BamFile(path, backend="native")
    assert bam.backend == "native"
    bam._table_handle = bam._native
    bam._native = bamcore.NativeBam(path, nthreads=nthreads)
    return bam


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    """The reference package's Python reader and the port's native reader
    at each thread count, over one fixture."""
    if not _native_available():
        pytest.skip("the port's native BAM core cannot be built here")
    path = _fixture(tmp_path_factory.mktemp("pooldecode"))
    return (RefBam(path, backend="python"),
            {nt: _native(path, nt) for nt in NTHREADS})


def _members(ref, lo, hi):
    """Members that hold records [lo, hi) of the fixture."""
    last = int(ref._upos[hi - 1]) + 4 + struct.unpack_from(
        "<i", ref._payload, int(ref._upos[hi - 1]))[0] - 1
    return last // BLOCK - int(ref._upos[lo]) // BLOCK + 1


def _queries_equal(ref, nat, chrom, s, e, quality_threshold):
    kw = {"quality_threshold": quality_threshold}
    assert ref.coverage_sum(chrom, s, e, **kw) == \
        nat.coverage_sum(chrom, s, e, **kw)
    assert ref.coverage_sum(chrom, s, e, flag_exclude=FLAG_EXCLUDE_ALL,
                            min_mapq=20, **kw) == \
        nat.coverage_sum(chrom, s, e, flag_exclude=FLAG_EXCLUDE_ALL,
                         min_mapq=20, **kw)
    np.testing.assert_array_equal(ref.coverage_profile(chrom, s, e, **kw),
                                  nat.coverage_profile(chrom, s, e, **kw))


@pytest.mark.parametrize("quality_threshold", [0, 15])
@pytest.mark.parametrize("nthreads", NTHREADS)
def test_coverage_matches_across_threads(bams, nthreads, quality_threshold):
    ref, nats = bams
    nat = nats[nthreads]
    rng = random.Random(5)
    for _ in range(12):
        chrom = rng.choice(["chr1", "chr2"])
        s = rng.randrange(0, 1_000_000)
        _queries_equal(ref, nat, chrom, s, s + rng.randrange(1, 60_000),
                       quality_threshold)
    for chrom, length in REFS:
        lo, hi = ref.overlap_range(chrom, 0, length)
        assert _members(ref, lo, hi) > 2 * WINDOW_MAX
        assert ref.coverage_sum(chrom, 0, length,
                                quality_threshold=quality_threshold) == \
            nat.coverage_sum(chrom, 0, length,
                             quality_threshold=quality_threshold)


@pytest.mark.parametrize("nthreads", NTHREADS)
def test_del_gaps_match_across_threads(bams, nthreads):
    ref, nats = bams
    for chrom, s, e in [("chr1", 0, 1_000_000), ("chr2", 250_000, 2_000_000),
                        ("chr1", 400_000, 430_000)]:
        a = ref.del_gap_alignments(chrom, s, e, min_del_len=600)
        assert a == nats[nthreads].del_gap_alignments(chrom, s, e,
                                                      min_del_len=600)
        assert len(a) > 0


@pytest.mark.parametrize("edge", sorted(EDGES))
@pytest.mark.parametrize("nthreads", NTHREADS)
def test_decode_edge_ranges(bams, nthreads, edge):
    ref, nats = bams
    chrom, s, e = EDGES[edge]
    lo, hi = ref.overlap_range(chrom, s, e)
    if edge == "mid_block":
        assert ref._upos[lo] % BLOCK > 0
        assert _members(ref, lo, hi) > WINDOW_MAX
    elif edge == "last_record":
        assert hi == ref.n_records and _members(ref, lo, hi) > 1
    elif edge == "one_record":
        assert hi - lo == 1
    elif edge == "empty":
        assert hi == lo
    else:
        assert 1 < _members(ref, lo, hi) < max(NTHREADS)
    for qt in (0, 15):
        _queries_equal(ref, nats[nthreads], chrom, s, e, qt)
    assert ref.del_gap_alignments(chrom, s, e, min_del_len=30) == \
        nats[nthreads].del_gap_alignments(chrom, s, e, min_del_len=30)


def _member_offsets(raw):
    """Byte offset of every BGZF member of ``raw``."""
    out, p = [], 0
    while p < len(raw):
        out.append(p)
        xlen, = struct.unpack_from("<H", raw, p + 10)
        q = p + 12
        while q < p + 12 + xlen:
            if raw[q:q + 2] == b"BC":
                p += struct.unpack_from("<H", raw, q + 4)[0] + 1
                break
            q += 4 + struct.unpack_from("<H", raw, q + 2)[0]
    return out


@pytest.mark.parametrize("damage,message", [
    ("truncated_in_member", "truncated BGZF block"),
    ("truncated_at_member", "unexpected EOF in region decode"),
    ("corrupt_member", "BGZF inflate failed"),
    ("corrupt_member_truncated_after", "BGZF inflate failed"),
])
@pytest.mark.parametrize("nthreads", [2, 8])
def test_decode_errors_match_one_thread(bams, tmp_path, nthreads, damage,
                                        message):
    """A member that a pooled window inflates, damaged after the scan,
    fails the decode with the one-thread path's message."""
    ref, _ = bams
    raw = open(ref.path, "rb").read()
    lo, hi = ref.overlap_range("chr1", 0, 2_000_000)
    k = (int(ref._upos[lo]) + int(ref._upos[hi - 1])) // 2 // BLOCK
    at = _member_offsets(raw)[k]
    errors = {}
    for nt in (1, nthreads):
        p = str(tmp_path / f"damaged{nt}.bam")
        open(p, "wb").write(raw)
        nat = _native(p, nt)
        if damage == "truncated_in_member":
            os.truncate(p, at + 40)
        elif damage == "truncated_at_member":
            os.truncate(p, at)
        else:
            xlen, = struct.unpack_from("<H", raw, at + 10)
            with open(p, "r+b") as fh:
                fh.seek(at + 12 + xlen)
                fh.write(b"\xff" * 8)
            if damage == "corrupt_member_truncated_after":
                os.truncate(p, _member_offsets(raw)[k + 2] + 40)
        # a quality threshold decodes every member of the reference
        with pytest.raises(RuntimeError) as err:
            nat.coverage_sum("chr1", 0, 2_000_000, quality_threshold=15)
        errors[nt] = str(err.value)
    assert errors[1] == errors[nthreads] == message


# ---- the scan's columns ---------------------------------------------------

COLUMN_THREADS = [1, 8]
MIN_DEL_LENS = [0, 1, 599, 600, 601, 10**9]


@pytest.fixture(scope="module")
def column_bams(bams):
    """The reference package's Python reader, its native reader (the full
    decode the port's column path replaced) where it is built, and the
    port's native reader at 1 and 8 threads."""
    ref, nats = bams
    ref_native = (RefBam(ref.path, backend="native")
                  if _ref_native_available() else None)
    return ref, ref_native, {nt: nats[nt] for nt in COLUMN_THREADS}


def _counts():
    from coral_tpu_torch.native import bamcore

    return bamcore.counters()


def _delta(c0, c1):
    return {k: c1[k] - c0[k] for k in c0}


def _payload_bytes(ref, lo, hi):
    """Payload bytes of the members a full decode of records [lo, hi)
    inflates: from the member of record lo's first byte up to the member
    where record hi starts (that one too unless hi starts it), or to the
    end of the file after the last record."""
    if lo >= hi:
        return 0
    first = int(ref._upos[lo]) // BLOCK
    if hi < ref.n_records:
        up = int(ref._upos[hi])
        end = up // BLOCK + (up % BLOCK > 0)
    else:
        end = -(-len(ref._payload) // BLOCK)
    return min(end * BLOCK, len(ref._payload)) - first * BLOCK


def _record_in(ref, name):
    return next(i for i in range(ref.n_records) if ref.name(i) == name)


def _column_queries(ref, case):
    rng = random.Random(17)
    if case == "random":
        out = []
        for _ in range(40):
            s = rng.randrange(0, 1_000_000)
            out.append((rng.choice(["chr1", "chr2"]), s,
                        s + rng.choice([1, 50, 3_000, 40_000, 300_000])))
        return out
    if case == "inside_one_read":
        out = []
        for i in rng.sample(range(ref.n_records), 20):
            if ref.end[i] - ref.pos[i] > 40:
                c = ref.references[int(ref.ref_id[i])][0]
                out.append((c, int(ref.pos[i]) + 10, int(ref.pos[i]) + 20))
        return out
    return [(c, 0, n) for c, n in REFS]


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("case", ["random", "inside_one_read",
                                  "whole_references"])
@pytest.mark.parametrize("nthreads", COLUMN_THREADS)
def test_column_coverage_sum(column_bams, nthreads, case, filtered):
    """A coverage sum without a quality threshold equals the reference
    readers' and the port's own per-base full decode; each call answers or
    walks every candidate record once, walks every straddling one, and
    on whole references inflates nothing."""
    ref, ref_native, nats = column_bams
    nat = nats[nthreads]
    kw = ({"flag_exclude": FLAG_EXCLUDE_ALL, "min_mapq": 20} if filtered
          else {})
    for chrom, s, e in _column_queries(ref, case):
        lo, hi = nat.overlap_range(chrom, s, e)
        c0 = _counts()
        got = nat.coverage_sum(chrom, s, e, **kw)
        d = _delta(c0, _counts())
        assert got == ref.coverage_sum(chrom, s, e, **kw)
        if ref_native is not None:
            assert got == ref_native.coverage_sum(chrom, s, e, **kw)
        assert got == int(nat.coverage_profile(chrom, s, e, **kw).sum())
        assert d["decode_column_records"] + d["decode_walked_records"] == \
            hi - lo
        straddle = [i for i in range(lo, hi)
                    if nat.end[i] > s and (nat.pos[i] < s or nat.end[i] > e)
                    and not nat.flag[i] & kw.get("flag_exclude", 0)
                    and nat.mapq[i] >= kw.get("min_mapq", 0)]
        assert d["decode_walked_records"] >= len(straddle)
        if not straddle:
            assert d["decode_walked_records"] == 0
            assert d["decode_inflated_bytes"] == 0
        if case == "inside_one_read" and not filtered:
            assert straddle == [i for i in range(lo, hi) if nat.end[i] > s]
        if case == "whole_references":
            assert hi - lo > 100 and d["decode_column_records"] == hi - lo


@pytest.mark.parametrize("nthreads", COLUMN_THREADS)
def test_quality_threshold_and_profile_inflate_as_before(column_bams,
                                                          nthreads):
    """A coverage sum with a quality threshold and a coverage profile walk
    every candidate record and inflate exactly the members that hold
    them, as the full decode always did."""
    ref, _, nats = column_bams
    nat = nats[nthreads]
    rng = random.Random(29)
    queries = [(c, 0, n) for c, n in REFS] + [
        (rng.choice(["chr1", "chr2"]), s, s + rng.randrange(1, 60_000))
        for s in (rng.randrange(0, 1_000_000) for _ in range(10))]
    for chrom, s, e in queries:
        lo, hi = nat.overlap_range(chrom, s, e)
        for call in (lambda: nat.coverage_sum(chrom, s, e,
                                              quality_threshold=15),
                     lambda: nat.coverage_profile(chrom, s, e),
                     lambda: nat.coverage_profile(chrom, s, e,
                                                  quality_threshold=15)):
            c0 = _counts()
            call()
            d = _delta(c0, _counts())
            assert d["decode_inflated_bytes"] == _payload_bytes(ref, lo, hi)
            assert d["decode_walked_records"] == hi - lo
            assert d["decode_column_records"] == 0


@pytest.mark.parametrize("min_del_len", MIN_DEL_LENS)
@pytest.mark.parametrize("nthreads", COLUMN_THREADS)
def test_column_del_gaps(column_bams, nthreads, min_del_len):
    """The deletion-gap search walks only records whose largest gap
    exceeds ``min_del_len`` and returns the reference readers' rows, in
    record order; a read whose largest gap is exactly 600 has rows below
    600 alone."""
    ref, ref_native, nats = column_bams
    nat = nats[nthreads]
    gap600 = _record_in(ref, "gap600")
    assert int(nat.max_gap[gap600]) == 600
    for chrom, s, e in [("chr1", 0, 2_000_000), ("chr2", 0, 2_000_000),
                        ("chr2", 1_550_000, 1_700_000),
                        ("chr1", 400_000, 430_000)]:
        lo, hi = nat.overlap_range(chrom, s, e)
        c0 = _counts()
        got = nat.del_gap_alignments(chrom, s, e, min_del_len=min_del_len)
        d = _delta(c0, _counts())
        assert got == ref.del_gap_alignments(chrom, s, e,
                                             min_del_len=min_del_len)
        if ref_native is not None:
            assert got == ref_native.del_gap_alignments(
                chrom, s, e, min_del_len=min_del_len)
        assert d["decode_column_records"] + d["decode_walked_records"] == \
            hi - lo
        need = sum(1 for i in range(lo, hi)
                   if nat.end[i] > s and nat.mapq[i] >= 20
                   and nat.max_gap[i] > min_del_len)
        assert need <= d["decode_walked_records"]
        assert len(got) <= need
        if chrom == "chr2" and s > 0:
            names = [row[0] for row in got]
            assert ("gap600" in names) == (min_del_len < 600)
            assert ("gap700n" in names) == (min_del_len < 700)
            assert "gap0" not in names
        if min_del_len == 10**9:
            assert not got and d["decode_walked_records"] == 0
            assert d["decode_inflated_bytes"] == 0


def test_scan_columns_match_the_records(column_bams):
    """Each record's aligned-base count and largest gap between aligned
    blocks, as the scan keeps them, from the reference reader's records."""
    ref, _, nats = column_bams
    buf = memoryview(ref._payload)
    aligned, max_gap = [], []
    for i in range(ref.n_records):
        rec = ref._decode_at(buf, i)
        aligned.append(sum(n for _, n, _ in rec.aligned_runs()))
        b = rec.blocks()
        max_gap.append(max((abs(b[k + 1][0] - b[k][1])
                            for k in range(len(b) - 1)), default=0))
    for nat in nats.values():
        np.testing.assert_array_equal(nat.aligned, aligned)
        np.testing.assert_array_equal(nat.max_gap, max_gap)


def test_scan_cache_keeps_columns_and_rescans_an_old_version(column_bams,
                                                             tmp_path):
    """The scan cache keeps both columns; a cache of the version before
    them (no columns, version 2) is rescanned and rewritten."""
    ref, _, nats = column_bams
    p = str(tmp_path / "cached.bam")
    with open(ref.path, "rb") as src, open(p, "wb") as dst:
        dst.write(src.read())
    first = BamFile(p, backend="native", scan_cache=True)
    assert not first.scan_from_cache
    again = BamFile(p, backend="native", scan_cache=True)
    assert again.scan_from_cache
    for col in ("aligned", "max_gap"):
        np.testing.assert_array_equal(getattr(again, col),
                                      getattr(nats[1], col))
    assert again.coverage_sum("chr1", 0, 2_000_000) == \
        ref.coverage_sum("chr1", 0, 2_000_000)
    assert again.del_gap_alignments("chr2", 0, 2_000_000, 600) == \
        ref.del_gap_alignments("chr2", 0, 2_000_000, 600)
    # the same file as the version before the columns wrote it: the two
    # trailing column vectors gone, the version field 2
    raw = bytearray(open(p + ".scanx", "rb").read())
    assert struct.unpack_from("<II", raw, 0)[1] == 3
    n = again.n_records
    old = raw[:len(raw) - 2 * (8 + 8 * n)]
    struct.pack_into("<I", old, 4, 2)
    with open(p + ".scanx", "wb") as fh:
        fh.write(old)
    os.utime(p + ".scanx")
    rescanned = BamFile(p, backend="native", scan_cache=True)
    assert not rescanned.scan_from_cache
    for col in ("aligned", "max_gap"):
        np.testing.assert_array_equal(getattr(rescanned, col),
                                      getattr(nats[1], col))
    assert rescanned.coverage_sum("chr2", 0, 2_000_000) == \
        ref.coverage_sum("chr2", 0, 2_000_000)
    assert struct.unpack_from("<II", open(p + ".scanx", "rb").read(),
                              0)[1] == 3
    assert BamFile(p, backend="native", scan_cache=True).scan_from_cache


@pytest.fixture(scope="module")
def dense_bams(tmp_path_factory):
    """Short reads every 33 bases, in members of 4,096 bytes (a dozen
    records each), so that runs of straddling records share members with
    records answered from the columns: the reference package's Python
    reader and the port's native reader at 1 and 8 threads."""
    if not _native_available():
        pytest.skip("the port's native BAM core cannot be built here")
    rng = random.Random(8)
    qrng = np.random.default_rng(8)
    recs = []
    for i in range(3000):
        m1 = rng.randrange(10, 200)
        if rng.random() < 0.4:
            m2 = rng.randrange(10, 200)
            cigar = f"{m1}M{rng.choice([5, 599, 600, 601, 900])}D{m2}M"
            qlen = m1 + m2
        else:
            cigar, qlen = f"{m1}M", m1
        recs.append(BamRecord(
            f"d{i:05d}", rng.choice([0, 16, 0x100, 0x800]), "chr1", 33 * i,
            rng.randrange(0, 61), cigar,
            quals=qrng.integers(0, 60, qlen, dtype=np.uint8).tobytes(),
            tags={"NM": 1}))
    d = tmp_path_factory.mktemp("densecols")
    src = str(d / "src.bam")
    write_bam(src, REFS, recs)
    payload = gzip.decompress(open(src, "rb").read())
    p = str(d / "dense.bam")
    with open(p, "wb") as fp:
        for i in range(0, len(payload), 4096):
            fp.write(compress_block(payload[i:i + 4096], level=1))
        fp.write(BGZF_EOF)
    return (RefBam(p, backend="python"),
            {nt: _native(p, nt) for nt in COLUMN_THREADS})


@pytest.mark.parametrize("query", ["coverage_sum", "del_gaps"])
@pytest.mark.parametrize("nthreads", COLUMN_THREADS)
def test_column_runs_share_members(dense_bams, nthreads, query):
    """Runs of walked records that meet in a member are decoded as one,
    the records between them walked and skipped: the results equal the
    reference reader's, and more records are walked than need it."""
    ref, nats = dense_bams
    nat = nats[nthreads]
    rng = random.Random(31)
    walked = needed = 0
    for _ in range(60):
        s = rng.randrange(0, 95_000)
        e = s + rng.choice([30, 300, 3_000])
        lo, hi = nat.overlap_range("chr1", s, e)
        c0 = _counts()
        if query == "coverage_sum":
            kw = rng.choice([{}, {"flag_exclude": FLAG_EXCLUDE_ALL,
                                  "min_mapq": 20}])
            assert nat.coverage_sum("chr1", s, e, **kw) == \
                ref.coverage_sum("chr1", s, e, **kw)
            needed += sum(
                1 for i in range(lo, hi)
                if nat.end[i] > s and (nat.pos[i] < s or nat.end[i] > e)
                and not nat.flag[i] & kw.get("flag_exclude", 0)
                and nat.mapq[i] >= kw.get("min_mapq", 0))
        else:
            m = rng.choice([0, 599, 600])
            assert nat.del_gap_alignments("chr1", s, e, min_del_len=m) == \
                ref.del_gap_alignments("chr1", s, e, min_del_len=m)
            needed += sum(1 for i in range(lo, hi)
                          if nat.end[i] > s and nat.mapq[i] >= 20
                          and nat.max_gap[i] > m)
        d = _delta(c0, _counts())
        assert d["decode_column_records"] + d["decode_walked_records"] == \
            hi - lo
        walked += d["decode_walked_records"]
    assert needed < walked


# ---- the scan's table and the chimeras, against the reference package ---

@pytest.mark.parametrize("nthreads", NTHREADS)
def test_scan_table_and_chimeras_match_the_reference(bams, monkeypatch,
                                                     nthreads):
    """The port's native scan on ``nthreads`` threads and the chimeras its
    SA parse assembles equal the reference package's pure-Python reader
    and chimera collect: the references, every column both readers keep,
    and each split read's alignments, read length and the NM statistics."""
    from coral_tpu.ops.chimera import collect_chimeras as ref_collect
    from coral_tpu_torch.native import bamcore
    from coral_tpu_torch.ops.chimera import collect_chimeras

    ref, _ = bams
    opened = bamcore.NativeBam
    monkeypatch.setattr(bamcore, "NativeBam", lambda path, cache_path=None:
                        opened(path, nthreads=nthreads, cache_path=cache_path))
    nat = BamFile(ref.path, backend="native")
    assert nat.references == ref.references
    assert nat.n_records == ref.n_records
    for col in ("flag", "ref_id", "pos", "end", "mapq", "qlen", "nm",
                "name_off", "sa_off", "sa_len"):
        np.testing.assert_array_equal(getattr(nat, col), getattr(ref, col),
                                      err_msg=col)
    assert nat.name_blob == ref.name_blob
    assert nat.sa_blob == ref.sa_blob

    read_length, chim, nm_stats = collect_chimeras(nat)
    ref_length, ref_chim, ref_nm_stats = ref_collect(ref)
    assert nm_stats == ref_nm_stats
    assert list(chim) == list(ref_chim)
    assert read_length == {rn: ref_length[rn] for rn in ref_chim}
    for rn in ref_chim:
        got, want = chim[rn], ref_chim[rn]
        assert (got.q, got.r, got.mapq, got.nm) == \
            (want.q, want.r, want.mapq, want.nm), rn
    # the fixture reaches every branch of the SA parse
    assert len(ref_chim) == 44 and "noprimary" not in ref_chim
    assert len(ref_chim["noclip"]) == 0
    assert float("inf") in ref_chim["onebase"].nm
    assert {r[3] for c in ref_chim.values() for r in c.r} == {"+", "-"}
    assert max(len(c) for c in ref_chim.values()) == 3
