"""The benchmark's own sample generator: full-width records, seeded, and
exactly what the reference reads back."""
import hashlib
import json
import struct
import zlib

import numpy as np
import pytest

import compare
import generator
import model
from conftest import FOLDS, small_cell, small_circle


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
    bytes, tags, flag, CIGAR as (op, length))."""
    p = 8 + struct.unpack_from("<i", payload, 4)[0]
    n_ref = struct.unpack_from("<i", payload, p)[0]
    p += 4
    for _ in range(n_ref):
        p += 8 + struct.unpack_from("<i", payload, p)[0]
    out = []
    while p < len(payload):
        size = struct.unpack_from("<i", payload, p)[0]
        (_, pos, lname, _, _, ncig, flag, lseq, _, _, _) = \
            struct.unpack_from("<iiBBHHHiiii", payload, p + 4)
        q = p + 36
        name = payload[q:q + lname - 1]
        q += lname
        cig = struct.unpack_from(f"<{ncig}I", payload, q)
        span = sum(c >> 4 for c in cig if c & 0xF in (0, 2))
        dels = sum(c >> 4 for c in cig if c & 0xF == 2)
        q += 4 * ncig + (lseq + 1) // 2
        out.append((pos, span, dels, name, lseq, payload[q:q + lseq],
                    payload[q + lseq:p + 4 + size], flag,
                    [(c & 0xF, c >> 4) for c in cig]))
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


# -- the general shape ------------------------------------------------------

# SHA-256 of the small_cell-cut gbm39 sample's .bam, .cns, seed file and the
# reference's rows (graph and cycles, as JSON), written by the generator and
# reference of the commit before the general shape existed
PARENT = {
    5: ("f522d6534757819376e371058e5257350ae9b54708288677881963a029db8505",
        "df64a98c2dc418b3f1fab207577debc0655e41f0571bfeb3851fdfe7a88515d8",
        "f2a55c70ab726018d16f3c87a2fb6f1f53516bd004b4b73fa56cd767f01a09f5",
        "d043d08877ab7f1551d69762238b9844d40be4fc2f7e4c3e6ed0ad1694fe5dce"),
    2 ** 31 + 77: (
        "49713a12036a0de4ad8a30554da7592ca5917055f507d177fe3723dea5aa8aa0",
        "df64a98c2dc418b3f1fab207577debc0655e41f0571bfeb3851fdfe7a88515d8",
        "f2a55c70ab726018d16f3c87a2fb6f1f53516bd004b4b73fa56cd767f01a09f5",
        "05dbfdeffcaab14cd65e933b8b4ee9fef10e23e8ab946f89c5a3ada83e8f6550"),
}


def _sha(path):
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


@pytest.mark.parametrize("seed", sorted(PARENT))
def test_the_one_segment_circle_keeps_its_bytes_and_rows(seed, tmp_path):
    c = small_cell("full.gbm39")
    s = generator.write_sample(str(tmp_path), c.mix, seed)
    ref = compare.Reference(c.mix, seed, s.cns, s.seeds,
                            c.config["constants"])
    rows = json.dumps(ref.lines(0, True)).encode()
    assert (_sha(s.bam), _sha(s.cns), _sha(s.seeds),
            hashlib.sha256(rows).hexdigest()) == PARENT[seed]
    # the general form of the same circle writes the same sample
    general = dict(generator.shape(c.mix), circles=[])
    again = generator.write_sample(str(tmp_path / "g"), general, seed)
    assert [_sha(x) for x in (again.bam, again.cns, again.seeds)] == \
        [_sha(x) for x in (s.bam, s.cns, s.seeds)]


def test_the_whole_circle_mix_holds_the_readmes_graph():
    q = generator.shape(generator.load_mix("gbm39c"))
    at = [sg["at"] for sg in q["segments"]]
    assert at[0][0] == 54_659_673 and at[-1][1] == 56_149_665
    assert all(a[1] == b[0] for a, b in zip(at, at[1:]))
    assert [b - a for a, b in at] == [103609, 363985, 27754, 454170, 904,
                                      439275, 100295]
    assert [sg["amplified"] for sg in q["segments"]] == [False, True] * 3 + \
        [False]
    assert [(j["reads"], j["form"]) for j in q["junctions"]] == \
        [(981, "split"), (978, "split"), (869, "deletion")]
    assert q["circles"] == ["2+,4+,6+"]
    assert generator.amplified_span(q) == (54_763_282, 56_049_370)
    amp = [r for r in generator.cn_rows(q) if r[2]]
    assert amp == [(54_759_673, 56_049_665, True)]
    n = len(generator.tiled_reads(q)) + 2 * (981 + 978) + 869 + \
        sum(len(sp["starts"]) for sp in q["spanning_reads"])
    assert n == len(model.planted_records(q, 1).pos) == 171_615


def test_reference_reads_back_a_sample_of_several_walks(tmp_path):
    mix, seed = small_circle().mix, 3_000_000_023
    s = generator.write_sample(str(tmp_path), mix, seed)
    recs = _records(_payload(s.bam))
    planted = model.planted_records(mix, seed)
    got = sorted((r[0], r[0] + r[1], r[2]) for r in recs)
    want = sorted(zip(planted.pos.tolist(), planted.end.tolist(),
                      (planted.n_del + planted.gap).tolist()))
    assert got == want and s.n_records == len(recs)
    q = generator.shape(mix)
    split = sum(j["reads"] for j in q["junctions"] if j["form"] == "split")
    assert sum(b"SAZ" in r[6] for r in recs) == 2 * split
    dels = [r for r in recs if any(op == 2 and ln > 600 for op, ln in r[8])]
    assert len(dels) == q["junctions"][2]["reads"]
    assert {r[4] for r in recs} == {9500, 36000}


def test_every_orientation_is_planted_as_the_program_reads_it(tmp_path):
    """Each split read's two records, read back through the port's own SA
    decoding and breakpoint ends, give the ends the reference plants."""
    from coral_tpu_torch.ops.breakpoints import interval_to_bp
    from coral_tpu_torch.ops.chimera import alignment_from_sa

    seed = 3_000_000_029
    s = generator.write_sample(str(tmp_path), FOLDS, seed)
    by_name = {}
    for r in _records(_payload(s.bam)):
        if b"SAZ" in r[6]:
            cig = "".join(f"{ln}{'MIDNS'[op]}" for op, ln in r[8])
            nm = struct.unpack_from("<i", r[6], 3)[0]
            strand = "-" if r[7] & 0x10 else "+"
            by_name.setdefault(r[3], []).append(
                f"chr7,{r[0] + 1},{strand},{cig},60,{nm}")
    got = []
    for sa in by_name.values():
        ch = alignment_from_sa(sa, 9500)
        bp = interval_to_bp(ch.r[0], ch.r[1], ("read", 0, 1))
        got.append((bp[1], bp[2], bp[4], bp[5]))
    want = [(int(a), j.o_first, int(b), j.o_second)
            for j in model.planted_records(FOLDS, seed).junctions
            for a, b in zip(j.first, j.second)]
    assert sorted(got) == sorted(want) and len(want) == 85
    assert {(g[1], g[3]) for g in got} == {("+", "-"), ("-", "+"),
                                           ("+", "+"), ("-", "-")}


@pytest.mark.parametrize("bad", [
    {"ends": [[54_450_000, "x"], [54_650_000, "+"]], "reads": 1,
     "form": "split"},
    {"ends": [[54_650_000, "+"], [54_450_000, "-"]], "reads": 1,
     "form": "deletion"},
    {"ends": [[54_450_000, "+"], [54_450_003, "-"]], "reads": 1,
     "form": "split"}])
def test_a_junction_the_generator_cannot_plant_is_refused(bad):
    with pytest.raises(ValueError):
        generator.shape(dict(FOLDS, junctions=[bad]))
