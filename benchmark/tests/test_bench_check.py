"""The comparison that decides ``correct``: the control (the reference with
its CN balance in float32, in the program's place) fails it, and so does a
run whose timed path is broken underneath."""
import io

import numpy as np
import pytest

import compare
import control
import run
from conftest import CPU, small_cell


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
