"""The comparison that decides ``correct``: the control (the reference with
its CN balance in float32, in the program's place) fails it, and so does a
run whose timed path is broken underneath."""
import io

import numpy as np
import pytest

import compare
import control
import run
from conftest import CPU, FOLDS, small_cell, small_circle


@pytest.mark.parametrize("cell", ["graph.gbm39", "full.gbm39"])
def test_program_passes_and_control_fails(cell, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    c = small_cell(cell)
    rows = control.readings(c, [5, 2 ** 31 + 77], overrides=CPU,
                            out=io.StringIO())
    for r in rows:
        assert r["program_ok"] and not r["control_ok"]
        assert r["program"]["mismatches"] == 0
        assert r["control"]["cn_rel_gap"] > c.config["check"]["cn_rel_gap"]


def test_float64_reference_is_its_own_fixed_point():
    w, c, lg = [3e9, 1e3], [2e5, 4.0], [-0.5, 150000.0]
    A = np.array([[1.0, -1.0]])
    x64 = compare.model.solve_balance(w, c, lg, A, 1e-10)
    x32 = compare.model.solve_balance(w, c, lg, A, 1e-10, np.float32)
    assert np.all(x64 > 0) and np.max(np.abs(x32 / x64 - 1)) > 1e-9


def _run(tmp_path, monkeypatch, cell="full.gbm39"):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    return run.run_cell(small_cell(cell), 2 ** 31 + 3, 0.2, False, CPU,
                        io.StringIO())


def test_a_stage_that_leaves_its_state_unchanged_is_caught(tmp_path,
                                                          monkeypatch):
    from coral_tpu_torch.reconstruct import Reconstruction

    monkeypatch.setattr(Reconstruction, "compute_cn", lambda self, **k: None)
    res = _run(tmp_path, monkeypatch, "graph.gbm39")
    assert res["correct"] is False and res["failed"] == res["attempted"]


def test_half_the_pairs_left_out_is_caught(tmp_path, monkeypatch):
    from coral_tpu_torch.ops import pairs

    orig = pairs.score_pairs_l

    def half(*a, **k):
        pi, pj, hits = orig(*a, **k)
        hits = np.asarray(hits).copy()
        hits[1::2] = False
        return pi, pj, hits
    monkeypatch.setattr(pairs, "score_pairs_l", half)
    res = _run(tmp_path, monkeypatch, "graph.gbm39")
    assert res["correct"] is False and res["check"]["mismatches"]["value"] > 0


def test_an_answer_altered_where_it_is_produced_is_caught(tmp_path,
                                                          monkeypatch):
    from coral_tpu_torch.graph import breakpoint_graph

    orig = breakpoint_graph.write_graph_file

    def altered(g, path):
        g.discordant_edges[0].lr_count += 1
        return orig(g, path)
    monkeypatch.setattr(breakpoint_graph, "write_graph_file", altered)
    res = _run(tmp_path, monkeypatch)
    assert res["correct"] is False and res["check"]["mismatches"]["value"] > 0


def test_a_breakpoint_shifted_by_one_base_is_caught(tmp_path, monkeypatch):
    from coral_tpu_torch.ops import breakpoints

    orig = breakpoints._consensus_coord
    monkeypatch.setattr(breakpoints, "_consensus_coord",
                        lambda v, strand: orig(v, strand) + 1)
    res = _run(tmp_path, monkeypatch, "graph.gbm39")
    assert res["correct"] is False and res["check"]["mismatches"]["value"] > 0


# -- a sample of several walks: GBM39's whole circle, cut ---------------------

def test_the_port_meets_the_whole_circle_and_the_control_does_not(
        tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    c = small_circle()
    lim = c.config["check"]
    rows = control.readings(c, [7, 2 ** 31 + 79], overrides=CPU,
                            out=io.StringIO())
    for r in rows:
        assert r["program_ok"], r["program"]
        assert r["program"]["mismatches"] == 0
        assert not r["control_ok"] and r["control"]["mismatches"] == 0
        for k in ("cn_rel_gap", "coverage_rel_gap"):
            assert r["control"][k] > 10 * lim[k] > 100 * r["program"][k]


def _run_circle(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    return run.run_cell(small_circle(), 2 ** 31 + 81, 0.2, False, CPU,
                        io.StringIO())


def test_the_whole_circle_runs_through_the_harness(tmp_path, monkeypatch):
    res = _run_circle(tmp_path, monkeypatch)
    assert res["correct"] is True and res["failed"] == 0
    assert list(res["check"]) == ["mismatches", "cn_rel_gap",
                                  "coverage_rel_gap", "cap_excess",
                                  "failed_samples"]


@pytest.mark.parametrize("fault, number", [
    ("copy_over_cap", "cap_excess"), ("path_dropped", "mismatches"),
    ("support_off_by_one", "mismatches")])
def test_a_decomposition_altered_where_it_is_written_is_caught(
        fault, number, tmp_path, monkeypatch):
    from coral_tpu_torch.cycles import output

    orig = output.output_cycles

    def altered(rec, prefix, **k):
        if fault == "copy_over_cap":
            # the cycle sits at its discordant edge's CN
            rec.cycle_weights[0][0][0] *= 1 + 1e-6
        elif fault == "path_dropped":
            for kept in (rec.cycles[0], rec.cycle_weights[0],
                         rec.path_constraints_satisfied[0]):
                kept[1] = []
        else:
            rec.longest_path_constraints[0][2][0] += 1
        return orig(rec, prefix, **k)
    monkeypatch.setattr(output, "output_cycles", altered)
    res = _run_circle(tmp_path, monkeypatch)
    assert res["correct"] is False
    assert res["check"][number]["value"] > res["check"][number]["limit"]


def test_every_orientation_meets_the_port_in_the_graph(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    c = small_cell("graph.gbm39")
    c.mix = FOLDS
    res = run.run_cell(c, 2 ** 31 + 83, 0.2, False, CPU, io.StringIO())
    assert res["correct"] is True, res["check"]
