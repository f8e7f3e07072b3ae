"""The reference's decomposition and path-constraint writer on GBM39's
graph as CoRAL's README publishes it ("Expected output"): one cycle at the
largest copy count its edges allow, one path, and the CN-weighted length
that is the global optimum of CoRAL's model (docs/GBM39_PARITY.md)."""
import pytest

import compare
import model

# CoRAL's README, "Expected output" (GBM39, nanopore WGS), verbatim
GBM39_GRAPH = """\
SequenceEdge: StartPosition, EndPosition, PredictedCN, AverageCoverage, Size, NumberOfLongReads
sequence\tchr7:54659673-\tchr7:54763281+\t4.150534\t45.907363\t103609\t576
sequence\tchr7:54763282-\tchr7:55127266+\t89.340352\t1052.714362\t363985\t40637
sequence\tchr7:55127267-\tchr7:55155020+\t2.843655\t32.729552\t27754\t172
sequence\tchr7:55155021-\tchr7:55609190+\t89.340352\t1013.182857\t454170\t49675
sequence\tchr7:55609191-\tchr7:55610094+\t2.868261\t31.027655\t904\t915
sequence\tchr7:55610095-\tchr7:56049369+\t89.340352\t1023.280633\t439275\t49106
sequence\tchr7:56049370-\tchr7:56149664+\t4.150534\t49.623899\t100295\t562
BreakpointEdge: StartPosition->EndPosition, PredictedCN, NumberOfLongReads
concordant\tchr7:54763281+->chr7:54763282-\t4.150534\t26
concordant\tchr7:55127266+->chr7:55127267-\t2.843655\t36
concordant\tchr7:55155020+->chr7:55155021-\t2.843655\t32
concordant\tchr7:55609190+->chr7:55609191-\t2.697741\t38
concordant\tchr7:55610094+->chr7:55610095-\t2.697741\t41
concordant\tchr7:56049369+->chr7:56049370-\t4.150534\t45
discordant\tchr7:55610095-->chr7:55609190+\t86.642611\t869
discordant\tchr7:56049369+->chr7:54763282-\t85.189818\t981
discordant\tchr7:55155021-->chr7:55127266+\t86.496697\t978
"""

# its cycles file's decomposition rows, verbatim
PUBLISHED_WALKS = """\
Path constraint\t1\t2+,3+,4+\tSupport=6\tSatisfied
Path constraint\t2\t4+,5+,6+\tSupport=34\tSatisfied
Cycle=1;Copy_count=82.34616279663038;Segments=2+,4+,6+;Path_constraints_satisfied=
Cycle=2;Copy_count=2.8436550275157644;Segments=0+,2+,3+,4+,5+,6+,0-;Path_constraints_satisfied=1,2
"""


def _graph():
    """The published graph as the reference's edges and their CN."""
    edges, cn = [], []
    for line in GBM39_GRAPH.splitlines():
        f = line.split("\t")
        if f[0] == "sequence":
            s = int(f[1].split(":")[1][:-1])
            e = int(f[2].split(":")[1][:-1])
            edges.append(model.Edge("sequence", (s, e), int(f[6])))
        elif f[0] in ("concordant", "discordant"):
            m = compare._DISC.match(f[1])
            edges.append(model.Edge(f[0], (int(m[1]), m[2], int(m[3]), m[4]),
                                    int(f[3])))
        else:
            continue
        cn.append(float(f[3] if f[0] == "sequence" else f[2]))
    return model.Walks(edges), cn


def _steps(text):
    return [(int(t[:-1]) - 1, t[-1]) for t in text.split(",")]


def _decompose():
    w, cn = _graph()
    pcs = [[_steps("2+,3+,4+"), 6], [_steps("4+,5+,6+"), 34]]
    return w, cn, model.decompose(w, cn, [_steps("2+,4+,6+")], pcs, 0.9)


def test_the_published_graph_gives_one_cycle_and_one_path():
    w, cn, dec = _decompose()
    assert [(model.walk_text(t), cyc) for t, cyc, _, _ in dec.walks] == \
        [("2+,4+,6+", True), ("1+,2+,3+,4+,5+,6+,7+", False)]
    cycle, path = (copy for _, _, copy, _ in dec.walks)
    assert cycle == pytest.approx(85.189818, rel=1e-12)      # d 56049369+
    assert path == pytest.approx(2.697741, rel=1e-12)        # c 55609190+
    assert dec.coverage == pytest.approx(111_139_845.356, rel=1e-9)


def _text(rows):
    return "\n".join((";" if r[0].startswith("Cycle=") else "\t").join(
        f"Copy_count={f!r}" if isinstance(f, float) else f for f in r)
        for r in rows)


def test_the_writer_prints_the_published_constraints_and_walks():
    w, cn, dec = _decompose()
    rows = model.walks_lines("chr7", w, 54659673, 56149664, dec)
    assert rows[2] == ["Segment", "1", "chr7", "54659673", "54763281"]
    assert rows[10:12] == [
        ["Path constraint", "1", "2+,3+,4+", "Support=6", "Satisfied"],
        ["Path constraint", "2", "4+,5+,6+", "Support=34", "Satisfied"]]
    assert [r[0] for r in rows[12:]] == ["Cycle=1", "Cycle=2"]
    assert rows[12][2:] == ["Segments=2+,4+,6+", "Path_constraints_satisfied="]
    assert rows[13][2:] == ["Segments=0+,1+,2+,3+,4+,5+,6+,7+,0-",
                            "Path_constraints_satisfied=1,2"]
    seen = compare.read_walks(compare._rows(_text(rows)), w, cn)
    assert seen["cap_excess"] == 0.0 and seen["paths"] == 1
    assert seen["coverage"] == pytest.approx(dec.coverage, rel=1e-15)
    assert seen["met"] == {"2+,3+,4+", "4+,5+,6+"}


def test_the_published_copy_counts_exceed_a_concordant_cap():
    w, cn, dec = _decompose()
    seen = compare.read_walks(compare._rows(PUBLISHED_WALKS), w, cn)
    # its path passes 4+ -> 5+ -> 6+ at 2.8437 over those edges' 2.697741
    assert seen["cap_excess"] == pytest.approx(2.8436550275157644 / 2.697741
                                               - 1, rel=1e-12)
    assert seen["circles"] == [compare._canonical(_steps("2+,4+,6+"))]
    assert seen["coverage"] < dec.coverage


def test_a_copy_count_over_its_cap_or_a_walk_off_the_graph_is_read():
    w, cn, dec = _decompose()
    text = _text(model.walks_lines("chr7", w, 54659673, 56149664, dec))
    over = text.replace(repr(85.189818), repr(85.189818 * 1.01))
    assert over != text
    assert compare.read_walks(compare._rows(over), w, cn)["cap_excess"] == \
        pytest.approx(0.01, rel=1e-9)
    off = PUBLISHED_WALKS.replace("Segments=2+,4+,6+", "Segments=2+,5+,6+")
    seen = compare.read_walks(compare._rows(off), w, cn)
    assert seen["unread"] == 1 and seen["cap_excess"] == float("inf")
