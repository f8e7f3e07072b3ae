"""The harness is driven by data; its byte counts, its result line and its
refusal to run without a card."""
import io
import json
import os
import shutil

import pytest

import devtrace
import kernel_bytes
import registry
import run
from conftest import BENCH, CPU, ROOT, small_cell


def test_new_config_mix_and_metric_are_found_without_edits(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    before = {p: open(p, "rb").read() for p in
              map(str, (root / "benchmark").rglob("*")) if os.path.isfile(p)}
    cfg = json.load(open(root / "benchmark/configs/reconstruct_full.json"))
    json.dump(cfg, open(root / "benchmark/configs/reconstruct_new.json", "w"))
    mix = json.load(open(root / "benchmark/traffic/gbm39.json"))
    mix["domain"] = [54_000_000, 56_000_000]
    json.dump(mix, open(root / "benchmark/traffic/gbm39cut.json", "w"))
    (root / "benchmark/metrics/new_metric_s.py").write_text(
        'SPANS = {"new": ["os:getcwd"]}\n\n\ndef read(t):\n    return 1.0\n')
    spec["configs"].append({"name": "reconstruct_new", "source": "x",
                            "file": "benchmark/configs/reconstruct_new.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "new.gbm39cut",
                              "config": "reconstruct_new",
                              "traffic": "gbm39cut", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "new_metric_s", "unit": "s",
                              "better": "lower", "source": "program_span",
                              "layer": "x", "moves": "cpu_s_per_sample",
                              "workloads": ["new.gbm39cut"]})
    json.dump(spec, open(root / "BENCHMARK.json", "w"))
    c = registry.cell(registry.load_spec(str(root)), "new.gbm39cut",
                      bench_dir=str(root / "benchmark"), root=str(root))
    assert c.mix["domain"] == [54_000_000, 56_000_000] and c.config == cfg
    assert [m["name"] for m in c.per_layer] == ["new_metric_s"]
    reader = registry.metric_reader("new_metric_s",
                                    bench_dir=str(root / "benchmark"))
    assert reader.read(None) == 1.0 and "new" in reader.SPANS
    for p, data in before.items():
        assert open(p, "rb").read() == data


def test_every_cell_and_metric_of_the_benchmark_resolves():
    spec = registry.load_spec(ROOT)
    for w in spec["workloads"]:
        c = registry.cell(spec, w["name"])
        assert {m["name"] for m in c.end_to_end} == \
            {"cpu_s_per_sample", "peak_rss_gib", "setup_s"}
        assert c.per_layer
        for m in c.per_layer:
            assert callable(registry.metric_reader(m["name"]).read)


class _Cuda:
    class device:
        type = "cuda"

    def __init__(self, n):
        self.shape = (n,)


def test_k1_bytes_are_12_a_pair_and_the_mask():
    assert kernel_bytes.k1_bytes(1_500_000) == 12 * 1_500_000 + 1_500_000
    assert kernel_bytes.k1_launch_bytes((_Cuda(1000),), {}, None) == 13_000
    import torch

    cpu = torch.zeros(1000, dtype=torch.int32)
    assert kernel_bytes.k1_launch_bytes((cpu,), {}, None) == 0


def test_device_trace_busy_idle_and_breakdown(tmp_path):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "span:window",
           "ts": 0, "dur": 1000},
          {"ph": "X", "cat": "user_annotation", "name": "span:breakpoints",
           "ts": 100, "dur": 400},
          {"ph": "X", "cat": "gpu_user_annotation", "name": "span:window",
           "ts": 5, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "pair3_hitmask_kernel",
           "ts": 200, "dur": 50},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
           "ts": 240, "dur": 60},
          {"ph": "X", "cat": "kernel", "name": "late", "ts": 2000, "dur": 5}]
    path = tmp_path / "t.json"
    json.dump({"traceEvents": ev}, open(path, "w"))
    t = devtrace.read_chrome_trace(str(path))
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx(100e-6)
    assert t.op_seconds("pair3_hitmask") == pytest.approx(50e-6)
    assert t.top_ops()[0][0] == "Memcpy HtoD"
    gaps = t.idle_gaps()
    assert gaps[0] == ["outside_stages", pytest.approx(500e-6)]
    assert gaps[1] == ["breakpoints", pytest.approx(200e-6)]
    assert gaps[2] == ["outside_stages", pytest.approx(100e-6)]
    assert sum(g[1] for g in gaps) == pytest.approx(t.window_s - t.busy_s)


def test_run_without_a_card_fails_and_prints_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "graph.gbm39", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_result_line_keys_and_check_last(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    c = small_cell("full.gbm39")
    res = run.run_cell(c, 2 ** 31 + 5, 0.5, False, CPU, io.StringIO())
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "check"]
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"cpu_s_per_sample", "peak_rss_gib",
                                   "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    traced = run.run_cell(c, 2 ** 31 + 5, 0.5, True, CPU, io.StringIO())
    names = {m["name"] for m in c.per_layer}
    # no card traced: the device readers find nothing and are left out
    assert set(traced["metrics"]) == names - {"k1_roofline",
                                              "device_idle_pct"}
    assert os.listdir(tmp_path) == [] or all(
        not n.startswith("coral-bench-") for n in os.listdir(tmp_path))


@pytest.mark.cuda
def test_a_short_run_on_the_card(cuda_card, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    c = small_cell("graph.gbm39")
    res = run.run_cell(c, 2 ** 31 + 11, 1.0, True, None, io.StringIO())
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert 0 < res["device"]["busy_s"] < res["device"]["window_s"]
    assert 0 < res["metrics"]["k1_roofline"]["value"] <= 105


def test_peak_rss_is_the_windows_alone():
    import time

    import numpy as np

    base = run.resident_bytes()
    big = np.ones(400 << 20, np.uint8)
    high = run.resident_bytes()
    del big
    rss = run.PeakRss(period=0.005)
    rss.start()
    mid = np.ones(100 << 20, np.uint8)
    time.sleep(0.05)
    peak = rss.stop()
    del mid
    assert base + (80 << 20) < peak < high - (200 << 20)
