"""The port's spans and decode counters (``coral_tpu_torch.tracing``).

Off, a span is a shared no-op that reads no clock and calls nothing of
``torch``, and a whole reconstruct records nothing; on, each sample
records the six stage spans in pipeline order with the work-site spans
inside them, and writes the same files.  The native BAM core counts the
payload bytes that the scan and the region decodes inflate, as read back
from the BGZF file here; the program counts the rows of its deletion
search and the walks and MILP sizes of its decomposition, tracing off."""
import dataclasses
import gzip
import os
import struct
import time
import tracemalloc

import pytest
import torch

from coral_tpu_torch import tracing
from coral_tpu_torch.config import DEFAULT_CONFIG
from coral_tpu_torch.io.bam import BamFile
from coral_tpu_torch.reconstruct import reconstruct_cycles, reconstruct_graphs
from coral_tpu_torch.sim import simulate_ecdna

STAGES = ["scan_collect", "interval_search", "breakpoints", "graph_cn",
          "cycles", "path_constraints"]
WORK_SITES = ("bam.scan", "decode.", "chimera.parse_sa", "pair_scoring",
              "smalldel", "cycles.")
CFG = DEFAULT_CONFIG.replace(engine=dataclasses.replace(
    DEFAULT_CONFIG.engine, engine="torch"))


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    yield
    tracing.disable()


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tracing"))
    return simulate_ecdna(d, jitter=2, domain_end=57_400_000)


def _reconstruct(sample, prefix):
    bam, cns, seeds = sample
    rec = reconstruct_graphs(bam, seeds, cns, prefix, cfg=CFG, device="cpu")
    reconstruct_cycles(rec, prefix)
    rec.bam.close()
    outs = {}
    d, base = os.path.split(prefix)
    for f in sorted(os.listdir(d)):
        if f.startswith(base + "_amplicon"):
            with open(os.path.join(d, f), "rb") as fh:
                outs[f[len(base):]] = fh.read()
    cn = [[e.cn for e in g.sequence_edges + g.concordant_edges
           + g.discordant_edges] for g in rec.graphs]
    return outs, cn


@pytest.fixture(scope="module")
def runs(sample, tmp_path_factory):
    """One reconstruct with tracing off, one with it on: (outputs, CN,
    spans recorded) each, and the clock read either side of the traced
    run."""
    d = str(tmp_path_factory.mktemp("runs"))
    seq = tracing.last_seq()
    off = _reconstruct(sample, os.path.join(d, "off"))
    off_spans = tracing.spans_since(seq)
    tracing.enable()
    try:
        seq = tracing.last_seq()
        t_before = time.perf_counter()
        on = _reconstruct(sample, os.path.join(d, "on"))
        t_after = time.perf_counter()
        on_spans = tracing.spans_since(seq)
    finally:
        tracing.disable()
    return {"off": (*off, off_spans), "on": (*on, on_spans),
            "clock": (t_before, t_after)}


def test_tracing_off_records_no_span(runs):
    assert runs["off"][2] == []
    assert tracing.span("scan_collect") is tracing.span("graph_cn", sync=True)


def test_span_off_reads_no_clock_and_calls_no_torch(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("called while tracing is off")

    monkeypatch.setattr(time, "perf_counter", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    monkeypatch.setattr(torch.cuda, "is_initialized", boom)
    seq = tracing.last_seq()
    with tracing.span("graph_cn", sync=True):
        pass
    assert tracing.last_seq() == seq and tracing.spans_since(seq) == []


def test_span_off_allocates_nothing():
    def loop():
        for _ in range(2000):
            with tracing.span("decode.coverage_sum"):
                pass

    loop()
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        loop()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [s for s in after.compare_to(before, "filename")
             if s.traceback[0].filename == tracing.__file__ and s.size_diff]
    assert grown == []


def test_stage_spans_once_a_sample_in_pipeline_order(runs):
    spans = runs["on"][2]
    stages = sorted((r for r in spans if r.name in STAGES),
                    key=lambda r: r.t0)
    assert [r.name for r in stages] == STAGES
    lo, hi = runs["clock"]
    assert all(lo <= r.t0 <= r.t1 <= hi for r in spans)
    seqs = [r.seq for r in spans]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)


@pytest.mark.parametrize("site,stage", [
    ("bam.scan", "scan_collect"),
    ("chimera.parse_sa", "scan_collect"),
    ("decode.del_gaps", "interval_search"),
    ("pair_scoring", "breakpoints"),
    ("decode.coverage_sum", "scan_collect"),
    ("decode.coverage_sum", "graph_cn"),
    ("smalldel", "interval_search"),
    ("decode.del_gaps", "smalldel"),
    ("cycles.enumerate", "cycles"),
    ("cycles.solve", "cycles"),
    ("cycles.output", "cycles"),
])
def test_work_site_spans_nest_in_their_stage(runs, site, stage):
    spans = runs["on"][2]
    (outer,) = [r for r in spans if r.name == stage]
    inner = [r for r in spans if r.name == site
             and outer.t0 <= r.t0 and r.t1 <= outer.t1]
    assert inner


def test_every_work_site_span_sits_in_a_stage_span(runs):
    spans = runs["on"][2]
    stages = [r for r in spans if r.name in STAGES]
    sites = [r for r in spans if r.name.startswith(WORK_SITES)]
    assert {r.name for r in sites} >= {
        "bam.scan", "decode.coverage_sum", "decode.del_gaps",
        "chimera.parse_sa", "pair_scoring", "smalldel", "cycles.enumerate",
        "cycles.solve", "cycles.output"}
    assert {r.name for r in spans} <= set(STAGES) | {r.name for r in sites}
    for r in sites:
        assert any(s.t0 <= r.t0 and r.t1 <= s.t1 for s in stages), r


def test_outputs_identical_with_tracing_on_and_off(runs):
    outs_off, cn_off, _ = runs["off"]
    outs_on, cn_on, _ = runs["on"]
    assert any(k.endswith("_graph.txt") for k in outs_off)
    assert any(k.endswith("_cycles.txt") for k in outs_off)
    assert outs_on == outs_off
    assert cn_on == cn_off


def test_span_buffer_trims_its_head_in_order(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 8)
    monkeypatch.setattr(tracing, "SPANS", [])
    tracing.enable()
    seq0 = tracing.last_seq()
    for k in range(30):
        with tracing.span(f"s{k}"):
            pass
    kept = tracing.SPANS
    assert 0 < len(kept) <= 8
    assert [r.seq for r in kept] == list(range(kept[0].seq, seq0 + 31))
    assert kept[-1].name == "s29" and tracing.last_seq() == seq0 + 30
    assert [r.name for r in tracing.spans_since(seq0 + 27)] == \
        ["s27", "s28", "s29"]


# -- the native decode counters ------------------------------------------

def _bgzf_isizes(path):
    """ISIZE of every BGZF member of the file, read from its bytes."""
    data = open(path, "rb").read()
    out, p = [], 0
    while p < len(data):
        assert data[p:p + 4] == b"\x1f\x8b\x08\x04"
        xlen, = struct.unpack_from("<H", data, p + 10)
        q, bsize = p + 12, None
        while q < p + 12 + xlen:
            si1, si2, slen = struct.unpack_from("<BBH", data, q)
            if (si1, si2) == (66, 67):
                bsize, = struct.unpack_from("<H", data, q + 4)
            q += 4 + slen
        end = p + bsize + 1
        out.append(struct.unpack_from("<I", data, end - 4)[0])
        p = end
    return out


def _record_bytes_by_ref(path):
    """Bytes of the records (block_size + 4) of each reference id."""
    payload = gzip.decompress(open(path, "rb").read())
    l_text, = struct.unpack_from("<i", payload, 4)
    p = 8 + l_text
    n_ref, = struct.unpack_from("<i", payload, p)
    p += 4
    for _ in range(n_ref):
        l_name, = struct.unpack_from("<i", payload, p)
        p += 8 + l_name
    by_ref = {}
    while p < len(payload):
        block_size, ref_id = struct.unpack_from("<ii", payload, p)
        by_ref[ref_id] = by_ref.get(ref_id, 0) + 4 + block_size
        p += 4 + block_size
    return by_ref


def test_scan_inflates_the_whole_payload_once(sample):
    c0 = tracing.counters()
    bam = BamFile(sample[0])
    c1 = tracing.counters()
    assert bam.backend == "native"
    assert c1["scan_inflated_bytes"] - c0["scan_inflated_bytes"] == \
        sum(_bgzf_isizes(sample[0]))
    assert c1["decode_inflated_bytes"] == c0["decode_inflated_bytes"]
    bam.close()


# options under which each query walks every record of its range: a
# coverage sum with a quality threshold reads each base's quality, and a
# deletion-gap search that every gap passes and no MAPQ floor stops reads
# every record's CIGAR; the scan's columns answer neither
WALK_ALL = {"coverage_sum": {"quality_threshold": 15},
            "coverage_profile": {},
            "del_gap_alignments": {"min_del_len": -1, "min_mapq": 0}}


@pytest.mark.parametrize("query", ["coverage_sum", "coverage_profile",
                                   "del_gap_alignments"])
def test_region_decode_over_a_contig_inflates_its_records(sample, query):
    bam = BamFile(sample[0])
    rid = max(range(len(bam.references)),
              key=lambda i: _record_bytes_by_ref(sample[0]).get(i, 0))
    chrom, length = bam.references[rid]
    tracing.enable()
    seq, c0 = tracing.last_seq(), tracing.counters()
    getattr(bam, query)(chrom, 0, length, **WALK_ALL[query])
    c1 = tracing.counters()
    decoded = c1["decode_inflated_bytes"] - c0["decode_inflated_bytes"]
    assert decoded >= _record_bytes_by_ref(sample[0])[rid] > 0
    assert c1["scan_inflated_bytes"] == c0["scan_inflated_bytes"]
    name = "decode." + query.replace("del_gap_alignments", "del_gaps")
    assert [r.name for r in tracing.spans_since(seq)] == [name]
    bam.close()


def test_counters_survive_close(sample):
    import gc

    bam = BamFile(sample[0])
    chrom, length = bam.references[0]
    bam.coverage_sum(chrom, 0, length, **WALK_ALL["coverage_sum"])
    c1 = tracing.counters()
    assert c1["scan_inflated_bytes"] > 0 and c1["decode_inflated_bytes"] > 0
    bam.close()
    del bam
    gc.collect()
    assert tracing.counters() == c1


# -- the program's own counters -------------------------------------------

@pytest.mark.parametrize("backend", ["native", "python"])
def test_del_gap_alignments_counts_the_rows_it_returns(tmp_path, backend):
    """One record of five has a deletion over ``min_del_len``; the others
    have none, a short one, or one below the MAPQ floor."""
    from coral_tpu_torch.io.bamwrite import BamRecord, write_bam

    path = str(tmp_path / "del.bam")
    write_bam(path, [("chr7", 200_000)], [
        BamRecord("plain", 0, "chr7", 10_000, 60, "2000M"),
        BamRecord("short", 0, "chr7", 10_500, 60, "1000M40D1000M"),
        BamRecord("large", 0, "chr7", 11_000, 60, "1000M905D1000M"),
        BamRecord("lowq", 0, "chr7", 11_500, 5, "1000M905D1000M"),
        BamRecord("after", 0, "chr7", 30_000, 60, "1500M"),
    ])
    bam = BamFile(path, backend=backend)
    assert bam.backend == backend
    c0 = tracing.counters()["del_gap_alignments"]
    rows = bam.del_gap_alignments("chr7", 0, 200_000, 600, 20)
    c1 = tracing.counters()["del_gap_alignments"]
    assert [r[0] for r in rows] == ["large"]
    assert rows[0][2] == [(12_905, 12_000)]
    assert c1 - c0 == len(rows) == 1
    assert bam.del_gap_alignments("chr7", 0, 200_000, 1000, 20) == []
    assert tracing.counters()["del_gap_alignments"] == c1
    bam.close()


def test_decomposition_counters_count_with_tracing_off(sample, tmp_path,
                                                       monkeypatch):
    """Over one reconstruct, tracing off: the walks and path constraints
    its model files record and the variables and rows of every MILP
    handed to the solver."""
    import json

    from coral_tpu_torch.cycles import decomposition

    solves = []
    orig = decomposition.milp

    def recorded(*a, **k):
        solves.append((len(k["c"]),
                       sum(c.A.shape[0] for c in k["constraints"])))
        return orig(*a, **k)

    monkeypatch.setattr(decomposition, "milp", recorded)
    c0 = tracing.counters()
    seq = tracing.last_seq()
    _reconstruct(sample, str(tmp_path / "s"))
    c1 = tracing.counters()
    assert tracing.spans_since(seq) == []
    delta = {k: c1[k] - c0[k] for k in tracing.COUNTERS}
    models = [json.load(open(tmp_path / f))
              for f in sorted(os.listdir(tmp_path))
              if f.endswith("_model.json")]
    assert models and solves
    assert delta["walk_candidates"] == sum(m["candidates"] for m in models)
    assert delta["path_constraints_max"] == \
        sum(m["path_constraints"] for m in models)
    assert delta["milp_solves"] == len(solves)
    assert delta["milp_vars"] == sum(n for n, _ in solves) > 0
    assert delta["milp_rows"] == sum(r for _, r in solves) > 0
    assert delta["del_gap_alignments"] >= 0


# -- region decodes on the handle's threads ------------------------------

MEMBER = 2000   # payload bytes a member: the sample in about 1,800 members


@pytest.fixture(scope="module")
def small_members(sample, tmp_path_factory):
    """The sample's BAM rewritten as members of MEMBER payload bytes, so a
    decode over its contig reads several windows at 8 threads."""
    from coral_tpu_torch.io.bgzf import BGZF_EOF, compress_block

    payload = gzip.decompress(open(sample[0], "rb").read())
    p = str(tmp_path_factory.mktemp("members") / "small.bam")
    with open(p, "wb") as fp:
        for i in range(0, len(payload), MEMBER):
            fp.write(compress_block(payload[i:i + MEMBER], level=1))
        fp.write(BGZF_EOF)
    return p


def _decode_with(path, nthreads):
    """A native BamFile whose region decodes run on a handle opened with
    ``nthreads`` (the table stays a view of the first handle, kept)."""
    from coral_tpu_torch.native import bamcore

    bam = BamFile(path)
    assert bam.backend == "native"
    bam._table_handle = bam._native
    bam._native = bamcore.NativeBam(path, nthreads=nthreads)
    return bam


def _extent(py, chrom, s, e):
    """First and last member that hold the records over [s, e)."""
    lo, hi = py.overlap_range(chrom, s, e)
    end = int(py._upos[hi - 1]) + 4 + struct.unpack_from(
        "<i", py._payload, int(py._upos[hi - 1]))[0]
    return int(py._upos[lo]) // MEMBER, (end - 1) // MEMBER


@pytest.mark.parametrize("query", ["coverage_sum", "coverage_profile",
                                   "del_gap_alignments"])
def test_pooled_decode_inflates_the_same_members(small_members, query):
    """At 1 and 8 threads a decode that walks every record of its range
    inflates exactly the members from the one that holds its first
    record's first byte to the one that holds its last record's last
    byte; at 8 threads every window of more than one member (128 members
    a window) on the pool.  The deletion-gap search walks every record
    that ends past its start, so its ranges start at 0."""
    py = BamFile(small_members, backend="python")
    isizes = _bgzf_isizes(small_members)
    chrom, length = py.references[0]
    n = py.n_records
    regions = [(0, length),
               (0 if query == "del_gap_alignments" else int(py.pos[n // 3]),
                int(py.pos[2 * n // 3]))]
    expected = []
    for s, e in regions:
        first, last = _extent(py, chrom, s, e)
        assert last - first + 1 > 2 * 16 * 8      # several windows at 8
        assert (py.overlap_range(chrom, s, e)[1] == n) == (e == length)
        windows = [isizes[i:min(i + 128, last + 1)]
                   for i in range(first, last + 1, 128)]
        expected.append((sum(isizes[first:last + 1]),
                         sum(sum(w) for w in windows if len(w) > 1)))
    for nthreads in (1, 8):
        bam = _decode_with(small_members, nthreads)
        for (s, e), (want, want_pooled) in zip(regions, expected):
            c0 = tracing.counters()
            getattr(bam, query)(chrom, s, e, **WALK_ALL[query])
            c1 = tracing.counters()
            decoded = c1["decode_inflated_bytes"] - c0["decode_inflated_bytes"]
            pooled = c1["decode_pooled_bytes"] - c0["decode_pooled_bytes"]
            assert decoded == want
            assert pooled == (want_pooled if nthreads > 1 else 0)
        bam.close()


@pytest.mark.parametrize("members", ["one", "fewer_than_threads"])
def test_short_decode_pools_only_what_it_can_split(small_members, members):
    """A range of one member is inflated on the calling thread; a range
    of fewer members than the handle has threads goes to the pool whole,
    on one thread a member."""
    py = BamFile(small_members, backend="python")
    chrom, _ = py.references[0]
    isizes = _bgzf_isizes(small_members)
    s = int(py.pos[len(py.pos) // 2])

    def count(e):
        first, last = _extent(py, chrom, s, e)
        return last - first + 1

    want = (lambda k: k == 1) if members == "one" else (lambda k: 1 < k < 8)
    e = next(s + w for w in range(1, 100_000) if want(count(s + w)))
    first, last = _extent(py, chrom, s, e)
    bam = _decode_with(small_members, 8)
    c0 = tracing.counters()
    assert bam.coverage_sum(chrom, s, e) == py.coverage_sum(chrom, s, e)
    c1 = tracing.counters()
    decoded = c1["decode_inflated_bytes"] - c0["decode_inflated_bytes"]
    assert decoded == sum(isizes[first:last + 1])
    assert c1["decode_pooled_bytes"] - c0["decode_pooled_bytes"] == \
        (0 if members == "one" else decoded)
    bam.close()
