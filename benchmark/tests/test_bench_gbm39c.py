"""The cell ``full.gbm39c``: GBM39's whole circle on the default
reconstruct.  It resolves by name to its configuration, its mix and the
metrics that read the small-deletion search and the decomposition; on the
CPU, with its mix cut as ``small_circle`` cuts it, the port meets the
reference and the new readers find something to read."""
import io
import json
import os

import registry
import run
from conftest import CPU, ROOT, small_circle

CELL = "full.gbm39c"
NEW = {"smalldel_s", "walk_enum_s", "milp_s", "milp_vars"}


def _cell():
    return registry.cell(registry.load_spec(ROOT), CELL)


def test_the_cell_resolves_to_its_config_mix_and_metrics():
    c = _cell()
    assert (c.config_name, c.traffic, c.chips) == \
        ("reconstruct_gbm39c", "gbm39c", 1)
    assert c.mix == json.load(open(os.path.join(
        ROOT, "benchmark", "traffic", "gbm39c.json")))
    assert [m["name"] for m in c.end_to_end] == \
        ["cpu_s_per_sample", "peak_rss_gib", "setup_s"]
    assert {m["name"] for m in c.per_layer} == NEW
    for m in c.per_layer:
        assert m["moves"] == "cpu_s_per_sample"
        assert callable(registry.metric_reader(m["name"]).begin)


def test_the_config_cuts_the_genome_alone():
    c = _cell()
    full = registry.cell(registry.load_spec(ROOT), "full.gbm39").config
    conf = next(x for x in registry.load_spec(ROOT)["configs"]
                if x["name"] == "reconstruct_gbm39c")
    assert c.config["reduced"] == conf["reduced"] == ["genome_bp"]
    assert list(c.config["reduced_from"]) == ["genome_bp"]
    assert c.config["cli"] == full["cli"]
    assert c.config["constants"] == full["constants"]
    assert c.config["check"] == {"mismatches": 0, "cn_rel_gap": 1e-9,
                                 "coverage_rel_gap": 1e-9, "cap_excess": 1e-9}
    s = c.config["sample"]
    assert (s["genome_bp"], s["amplified_segments"], s["amplified_bp"]) == \
        (15_000_000, 3, 1_257_430)
    lo, hi = c.mix["domain"]
    assert hi - lo == s["genome_bp"]
    amp = [sg["at"] for sg in c.mix["segments"] if sg["amplified"]]
    assert len(amp) == 3 and sum(e - s for s, e in amp) == s["amplified_bp"]


def _small():
    """The cell with its own mix cut as ``small_circle`` cuts it."""
    c = _cell()
    c.mix = small_circle().mix
    return c


def test_the_port_meets_the_reference_on_the_cut_circle(tmp_path,
                                                        monkeypatch):
    from coral_tpu_torch import tracing

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    c = _small()
    c0 = tracing.counters()["del_gap_alignments"]
    res = run.run_cell(c, 2 ** 31 + 97, 0.2, False, CPU, io.StringIO())
    rows = tracing.counters()["del_gap_alignments"] - c0
    assert res["correct"] is True and res["failed"] == 0
    assert res["check"]["mismatches"]["value"] == 0
    assert list(res["check"]) == ["mismatches", "cn_rel_gap",
                                  "coverage_rel_gap", "cap_excess",
                                  "failed_samples"]
    # the warm-up and every sample of the window find each planted
    # deletion read once
    planted = sum(j["reads"] for j in c.mix["junctions"]
                  if j["form"] == "deletion")
    assert planted > 0 and rows == planted * (res["attempted"] + 1)


def test_the_new_readers_read_the_cut_circle(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    res = run.run_cell(_small(), 2 ** 31 + 101, 0.2, True, CPU,
                       io.StringIO())
    assert res["correct"] is True
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(got) == NEW
    assert got["smalldel_s"] > 0 and got["walk_enum_s"] > 0
    assert got["milp_s"] > 0 and got["milp_vars"] >= 1
    assert not [n for n in os.listdir(tmp_path) if n.startswith("coral-bench-")]
