"""The port's native region decodes against the reference package's
pure-Python reader, at 1, 2 and 8 inflate threads.

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
    src = str(tmp_path / "src.bam")
    write_bam(src, REFS, recs)
    payload = gzip.decompress(open(src, "rb").read())
    p = str(tmp_path / "small_blocks.bam")
    with open(p, "wb") as fp:
        for i in range(0, len(payload), BLOCK):
            fp.write(compress_block(payload[i:i + BLOCK], level=1))
        fp.write(BGZF_EOF)
    return p


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
        with pytest.raises(RuntimeError) as err:
            nat.coverage_sum("chr1", 0, 2_000_000)
        errors[nt] = str(err.value)
    assert errors[1] == errors[nthreads] == message
