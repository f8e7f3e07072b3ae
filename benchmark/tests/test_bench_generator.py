"""The benchmark's own sample generator: full-width records, seeded, and
exactly what the reference reads back."""
import struct
import zlib

import numpy as np

import generator
import model


def _payload(path):
    buf = open(path, "rb").read()
    out, off = [], 0
    while off < len(buf):
        xlen = struct.unpack_from("<H", buf, off + 10)[0]
        bsize = struct.unpack_from("<H", buf, off + 16)[0] + 1
        out.append(zlib.decompress(buf[off + 12 + xlen:off + bsize - 8], -15))
        off += bsize
    return b"".join(out)


def _records(payload):
    """Each record as (pos, ref span, deleted bases, name, l_seq, qual
    bytes, tags)."""
    p = 8 + struct.unpack_from("<i", payload, 4)[0]
    n_ref = struct.unpack_from("<i", payload, p)[0]
    p += 4
    for _ in range(n_ref):
        p += 8 + struct.unpack_from("<i", payload, p)[0]
    out = []
    while p < len(payload):
        size = struct.unpack_from("<i", payload, p)[0]
        (_, pos, lname, _, _, ncig, _, lseq, _, _, _) = \
            struct.unpack_from("<iiBBHHHiiii", payload, p + 4)
        q = p + 36
        name = payload[q:q + lname - 1]
        q += lname
        cig = struct.unpack_from(f"<{ncig}I", payload, q)
        span = sum(c >> 4 for c in cig if c & 0xF in (0, 2))
        dels = sum(c >> 4 for c in cig if c & 0xF == 2)
        q += 4 * ncig + (lseq + 1) // 2
        out.append((pos, span, dels, name, lseq, payload[q:q + lseq],
                    payload[q + lseq:p + 4 + size]))
        p += 4 + size
    return out


def _small(**cut):
    mix = generator.load_mix("gbm39")
    mix.update(domain=[54_500_000, 55_400_000], amp_extra_cov=20,
               n_junction_reads=40, cn_row_bp=100_000, **cut)
    return mix


def test_records_carry_seq_and_qual_of_their_read_length(tmp_path):
    mix = _small()
    recs = _records(_payload(generator.write_sample(str(tmp_path), mix,
                                                    2 ** 31 + 9).bam))
    assert all(r[4] == mix["read_len"] and len(r[5]) == mix["read_len"]
               for r in recs)
    quals = np.frombuffer(b"".join(r[5] for r in recs[:50]), np.uint8)
    assert 2 <= quals.min() and quals.max() <= 50
    assert abs(quals.mean() - mix["qual_mean"]) < 1
    assert all(len(r[3]) == 36 for r in recs)
    assert len({r[3] for r in recs}) == len(recs) - mix["n_junction_reads"]
    pos = [r[0] for r in recs]
    assert pos == sorted(pos)


def test_reference_reads_back_what_is_planted(tmp_path):
    mix, seed = _small(), 3_000_000_019
    s = generator.write_sample(str(tmp_path), mix, seed)
    recs = _records(_payload(s.bam))
    planted = model.planted_records(mix, seed)
    got = sorted((r[0], r[0] + r[1], r[2]) for r in recs)
    want = sorted(zip(planted.pos.tolist(), planted.end.tolist(),
                      planted.n_del.tolist()))
    assert got == want and s.n_records == len(recs)
    sa = [r for r in recs if b"SAZ" in r[6]]
    assert len(sa) == 2 * mix["n_junction_reads"]


def test_two_seeds_give_two_samples_of_one_size(tmp_path):
    mix = _small()
    a = generator.write_sample(str(tmp_path / "a"), mix, 3_000_000_001)
    b = generator.write_sample(str(tmp_path / "b"), mix, 3_000_000_002)
    ra, rb = _records(_payload(a.bam)), _records(_payload(b.bam))
    assert len(ra) == len(rb) == a.n_records == b.n_records
    assert [r[3] for r in ra] != [r[3] for r in rb]
    assert abs(sum(len(r[6]) for r in ra) - sum(len(r[6]) for r in rb)) \
        <= 4 * mix["n_junction_reads"]
    assert open(a.cns).read() == open(b.cns).read()
    again = generator.write_sample(str(tmp_path / "c"), mix, 3_000_000_001)
    assert _payload(again.bam) == _payload(a.bam)


def test_the_mix_file_holds_the_cells_sample():
    mix = generator.load_mix("gbm39")
    n = len(generator.tiled_reads(mix)) + 2 * mix["n_junction_reads"]
    assert n == 63_726
    rows = generator.cn_rows(mix)
    amp = [r for r in rows if r[2]]
    assert amp == [(54_759_673, 55_127_562, True)]
    assert rows[0][0] == 50_000_000 and rows[-1][1] == 60_000_000
