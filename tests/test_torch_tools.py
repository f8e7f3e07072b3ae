"""The port's tools (``coral_tpu_torch/tools``) against the JAX package's
(``tools/``, ``bench.py``, ``examples/quickstart.py``), on the CPU at
small sizes.

Tolerance: exact everywhere (arrays, bytes of the built inputs and of the
graph and cycles files, counts, JSON keys), but for the copy counts of
``bench_e2e``'s cycles file, whose CN engines differ (rtol 1e-9); times
are never compared.  The
tests marked ``cuda`` run the ``cuda`` engines on the card and skip
without one.  This module imports JAX and the JAX package only inside the
CPU tests.
"""
import filecmp
import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from coral_tpu_torch.tools import bench_common, bench_e2e, bench_kernels, \
    bench_multihost, bench_v3_ab, bench_wgs, quickstart, stress_scan

# the tiny WGS sample: 10 amplicons, 972,750 records
TINY = dict(read_len=1500, n_junction_reads=40, junction_flank=50, bg_cov=1)


def _same_bytes(a, b) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def test_smoke_inputs_equal_the_benchmarks(tmp_path):
    """The port keeps its own copies of the JAX package's input makers (it
    may import nothing of that package), now in ``tools.bench_common`` and
    ``tools.bench_wgs``: same arrays, and the same bytes for the
    replicated WGS sample at a small size."""
    import bench
    from tools import bench_wgs as jax_wgs

    a = bench_common.synth_scoring_batch(300, 16, seed=3)
    b = bench.synth_scoring_batch(300, 16, seed=3)
    for x, y in zip(a[:2] + a[3:], b[:2] + b[3:]):
        np.testing.assert_array_equal(x, y)
    assert list(a[2]) == list(b[2])
    for k in a[2]:
        np.testing.assert_array_equal(a[2][k], b[2][k])
    for x, y in zip(bench_common.synth_alignment_table(a[2]),
                    bench.synth_alignment_table(b[2])):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = bench_wgs.build(str(tmp_path / "port"), name="s", **TINY)
    want = jax_wgs.build(str(tmp_path / "jax"), name="s", **TINY)
    assert got[3] == want[3] > 0
    for g, w in zip(got[:3], want[:3]):
        assert _same_bytes(g, w)
    assert bench_wgs.CHROMS == jax_wgs.CHROMS
    assert bench_wgs.CHR_LEN == jax_wgs.CHR_LEN


def test_junction_heavy_sample_is_the_benchmarks(monkeypatch):
    """``build_junction_heavy`` asks ``build`` for the JAX tool's sample."""
    from tools import bench_wgs as jax_wgs

    calls = []
    for mod in (bench_wgs, jax_wgs):
        monkeypatch.setattr(mod, "build",
                            lambda *a, **kw: calls.append((a, kw)))
        mod.build_junction_heavy("out")
    assert len(calls) == 2 and calls[0] == calls[1]
    assert calls[0][1]["n_junction_reads"] == 150_000


def test_stress_scan_equals_jax(tmp_path, capsys):
    """``stress_scan``'s ``main`` at 2 chromosomes of 20 kb reads writes
    the bytes of the JAX tool's ``build_big(n_chroms=2, read_len=20000)``
    and scans, queries and collects them on the host, where no card is
    present: every record built is scanned, the JAX tool's lines then one
    JSON object, no CUDA context."""
    from tools import stress_scan as jax_stress

    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    assert stress_scan.main([str(tmp_path / "port"), "2", "20000"]) == 0
    *lines, last = capsys.readouterr().out.splitlines()
    out = json.loads(last)
    want = jax_stress.build_big(str(tmp_path / "jax"), n_chroms=2,
                                read_len=20000)
    assert out["records"] == out["records_built"] == want[1] > 0
    assert _same_bytes(tmp_path / "port" / "stress.bam", want[0])
    assert out["chimeric_reads"] > 0 and out["coverage_sum"] > 0
    assert [ln.split()[0] for ln in lines] == ["built", "native", "coverage",
                                               "chimera"]
    assert "device" not in out
    assert not torch.cuda.is_initialized()


@pytest.fixture(scope="module")
def tiny_wgs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tiny_wgs")
    return out, bench_wgs.build(str(out), name="s", **TINY)[:3]


@pytest.mark.parametrize("skip_cycles", [False, True],
                         ids=["cycles", "graphs"])
def test_run_staged_equals_jax(tiny_wgs, skip_cycles):
    """``run_staged`` with the ``torch`` engine on the CPU and with
    ``numpy``: the JAX tool's stage keys, amplicons and output files (the
    cycles files, or with ``skip_cycles`` the graph files), byte for byte,
    against the JAX ``run_staged(engine="numpy")``; ``on_graphs`` called
    once, with the Reconstruction."""
    from tools import bench_wgs as jax_wgs

    out, inputs = tiny_wgs
    tag = "g" if skip_cycles else "c"
    want = jax_wgs.run_staged(*inputs, str(out / f"jax_{tag}"),
                              engine="numpy", skip_cycles=skip_cycles)
    kind = "_graph.txt" if skip_cycles else "_cycles.txt"
    assert want[3] == 10 and len(want[2]) == 10
    assert all(f.endswith(kind) for f in want[2])
    for engine in ("torch", "numpy"):
        seen = []
        got = bench_wgs.run_staged(*inputs, str(out / f"{engine}_{tag}"),
                                   engine=engine, skip_cycles=skip_cycles,
                                   device="cpu", on_graphs=seen.append)
        # the hook sees the Reconstruction once, its graphs built before CN
        assert len(seen) == 1 and len(seen[0].graphs) == got[3]
        assert list(got[0]) == list(want[0])
        assert got[3] == want[3]
        assert {f.split("_", 2)[2]: t for f, t in got[2].items()} \
            == {f.split("_", 2)[2]: t for f, t in want[2].items()}
        if engine == "numpy":     # the host path records no route
            assert [r.engine for r in got[4]] \
                == [r.engine for r in want[4]]
            assert len(got[1]) == len(want[1])
        else:
            assert [r.engine for r in got[4]] == ["torch"]
            assert got[1] and all("engine=torch " in ln for ln in got[1])


def test_bench_e2e_equals_jax(tmp_path, monkeypatch, capsys):
    """The JAX tool's report keys and counts at 200 junction reads, and
    its cycles file."""
    from tools import bench_e2e as jax_e2e

    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    monkeypatch.setattr(sys, "argv", ["bench_e2e.py", jax_dir, "200"])
    jax_e2e.main()
    capsys.readouterr()
    assert bench_e2e.main([port_dir, "200", "--engine", "torch",
                           "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    reports = []
    for d in (jax_dir, port_dir):
        with open(os.path.join(d, "bench_e2e.json")) as fh:
            reports.append(json.load(fh))
    want, got = reports
    assert json.loads(printed) == got
    assert list(got) == list(want)
    for k in ("n_records", "n_chimeras", "n_breakpoints"):
        assert got[k] == want[k]
    assert want["n_chimeras"] == 200
    assert list(got["stages_s"]) == list(want["stages_s"]) \
        == list(bench_e2e.STAGES)
    # the JAX tool's CN engine is its per-graph jitted solve, the port's
    # the numpy engine: copy counts, printed with repr, agree to rtol 1e-9
    # (ROADMAP, divergences by design); every other byte is equal
    cycles = []
    for d in (jax_dir, port_dir):
        with open(os.path.join(d, "bench_amplicon1_cycles.txt")) as fh:
            cycles.append(fh.read().splitlines())
    assert len(cycles[0]) == len(cycles[1]) > 0
    for a, b in zip(*cycles):
        fa, fb = a.split(";"), b.split(";")
        assert len(fa) == len(fb)
        for x, y in zip(fa, fb):
            if x.startswith("Copy_count="):
                assert float(x[11:]) == pytest.approx(float(y[11:]),
                                                      rel=1e-9)
            else:
                assert x == y
    assert os.path.exists(os.path.join(port_dir,
                                       "bench_amplicon1_graph.txt"))


def _kernel_rows(engines, device):
    return (bench_kernels.bench_pair_predicates(1 << 14, engines=engines,
                                                device=device)
            + bench_kernels.bench_coverage_bins(1 << 14, 256,
                                                engines=engines,
                                                device=device)
            + bench_kernels.bench_match_matrix(300, engines=engines,
                                               device=device))


def test_bench_kernels_agree_on_cpu():
    """The three hot loops' ``torch`` engine at small shapes: every row
    agrees with its numpy reference, with the JAX tool's keys."""
    rows = _kernel_rows(("torch",), "cpu")
    assert [r["kernel"] for r in rows] == ["pair_predicates",
                                           "coverage_bins", "match_matrix"]
    assert all(r["agree"] and r["engine"] == "torch" for r in rows)
    assert set(rows[0]) == {"kernel", "engine", "n", "ms", "items_per_s",
                            "agree"}
    assert set(rows[1]) == set(rows[0]) | {"bins"}
    assert set(rows[2]) == set(rows[0]) - {"items_per_s"} | {"pairs_per_s"}
    head = next(bench_kernels.run("cpu"))
    assert head == {"platform": "cpu", "device": "cpu", "count": 1}


def _jax_pair_predicates(n):
    """The JAX tool's XLA predicate (``_pair_predicates``) on the port
    tool's case; with the torch engine's (hit, io)."""
    from coral_tpu.ops.pairs import _pair_predicates

    cols, ints, calls = bench_kernels.pair_predicate_case(n, device="cpu")
    zeros = np.zeros(n, np.float32)
    want = _pair_predicates(
        *(zeros if k.startswith("nm") else cols[k]
          for k in bench_kernels.PAIR_ORDER), *ints, bench_kernels.CUTOFF,
        bench_kernels.MIN_MAPQ, bench_kernels.GAP, np.inf)
    got = calls["torch"]()
    return [t.numpy() for t in got], [np.asarray(w) for w in want]


def _jax_coverage_bins(n):
    """``coral_tpu``'s ``CoverageIndex.bin_histogram`` (the JAX tool's
    reference) on the port tool's case; with the torch engine's sums and
    the tool's numpy reference."""
    from coral_tpu.ops.coverage import CoverageIndex

    starts, ends, bin_size, calls = bench_kernels.coverage_case(
        n, 256, device="cpu")
    want = CoverageIndex(starts, ends).bin_histogram(0, bin_size, 256)
    got = calls["torch"]().numpy()
    ref = bench_kernels.bin_overlap_np(starts, ends, 0, bin_size, 256)
    return [got, ref], [want, want]


def _jax_match_matrix(n):
    """``coral_tpu``'s Pallas match matrix (interpret mode) on the port
    tool's case; with the torch engine's matrix."""
    from coral_tpu.ops.pallas_kernels import match_matrix_pallas

    p1, p2, calls = bench_kernels.match_case(n, device="cpu")
    want = match_matrix_pallas(p1, p2, bench_kernels.MATCH_CUTOFF,
                               interpret=True)
    return [calls["torch"]().numpy() != 0], [want != 0]


@pytest.mark.parametrize("kernel,n", [(_jax_pair_predicates, 1 << 14),
                                      (_jax_coverage_bins, 1 << 14),
                                      (_jax_match_matrix, 300)],
                         ids=["pair_predicates", "coverage_bins",
                              "match_matrix"])
def test_bench_kernels_torch_equals_jax(kernel, n):
    """Each hot loop's case of ``bench_kernels`` through the port's
    ``torch`` engine equals the JAX package's function on the same
    arrays, exactly (and the coverage bins' numpy reference equals it
    too)."""
    got, want = kernel(n)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert any(w.any() for w in want)


def test_bench_v3_ab_torch_on_cpu():
    """The three routes through the kernels' plain versions at 2^16 pairs:
    v2 and v3 support identical, and the hit and support sums the JAX
    package's numpy predicate finds on the JAX tool's batch."""
    import bench
    from coral_tpu.native.bamcore import pack_pairs3
    from coral_tpu.ops.scoring import pair_predicate_packed3

    n = 1 << 16
    out = bench_v3_ab.run(n, engine="torch", device="cpu")
    assert out["support_identical"]
    _, _, cols, ic, is_, ie = bench.synth_scoring_batch(n)
    p3 = pack_pairs3(*bench.synth_alignment_table(cols), ic, is_, ie,
                     min_mapq=20)
    hit, iogm = pair_predicate_packed3(np, *p3, 100, 100.0)
    assert out["hitmask_sum"] == int(hit.sum()) > 0
    assert out["support_sum"] == int(
        np.bincount(iogm[hit], minlength=len(ic))[:len(ic)].sum())
    assert set(out) == {
        "pack2_ms", "pack3_ms", "support_identical", "support_sum",
        "hitmask_sum", "fused_v2_reads_per_s", "fused_v3_reads_per_s",
        "hitmask_v3_reads_per_s", "fused_v2_GBps", "fused_v3_GBps",
        "hitmask_v3_GBps"}


def test_bench_multihost_shards_agree(tiny_wgs, tmp_path):
    """The scaling loop at N = 1 and 2 on the tiny sample, the torch
    engine on the CPU: graph files identical across N."""
    _, (bam, cns, seeds) = tiny_wgs
    rows = []
    for row in bench_multihost.scaling(bam, seeds, cns, str(tmp_path),
                                       ns=(1, 2), reps=1,
                                       cfg=bench_common.engine_config(
                                           "torch"),
                                       device="cpu"):
        row["rec"].bam.close()
        rows.append(row)
    assert [r["processes"] for r in rows] == [1, 2]
    names = sorted(f[len("out_n1"):] for f in os.listdir(tmp_path)
                   if f.startswith("out_n1_amplicon"))
    assert len(names) == len(rows[0]["rec"].graphs) == 10
    for name in names:
        assert filecmp.cmp(tmp_path / f"out_n1{name}",
                           tmp_path / f"out_n2{name}", shallow=False)


def test_quickstart_runs_five_modes_on_cpu(tmp_path, capsys, monkeypatch):
    """The five CLI modes through ``python -m coral_tpu_torch`` on the
    CPU, each one's outputs written.  Each command line is checked and
    then run by the CLI's ``main`` in this process (the start of five
    interpreters would take most of the test's time); the package
    logger's state is put back afterwards."""
    import logging

    from coral_tpu_torch import cli

    spawn = quickstart.subprocess.run
    modes = []

    def in_process(cmd, *args, **kw):
        if cmd[:3] != [sys.executable, "-m", "coral_tpu_torch"]:
            return spawn(cmd, *args, **kw)    # a library's own command
        assert kw["check"] and not args
        assert kw["env"]["PYTHONPATH"].split(os.pathsep)[0] \
            == quickstart.ROOT
        modes.append(cmd[3])
        assert cli.main(cmd[3:]) == 0

    pkg = logging.getLogger("coral_tpu_torch")
    handlers = list(pkg.handlers)
    monkeypatch.setattr(pkg, "handlers", list(handlers))
    for attr in ("level", "propagate"):
        monkeypatch.setattr(pkg, attr, getattr(pkg, attr))
    monkeypatch.setattr(quickstart.subprocess, "run", in_process)
    try:
        cycles = quickstart.quickstart(str(tmp_path), device="cpu")
    finally:
        for h in pkg.handlers:
            if h not in handlers:
                h.close()
    printed = capsys.readouterr().out
    assert modes == [ln.split()[4] for ln in printed.splitlines()
                     if ln.startswith("$ python -m coral_tpu_torch")] \
        == ["seed", "reconstruct", "plot", "hsr", "cycle2bed"]
    assert "Cycle=" in open(cycles).read()
    made = os.listdir(tmp_path)
    for name in ("sample_CNV_SEEDS.bed", "sample_amplicon1_graph.txt",
                 "sample_cycles.bed"):
        assert name in made
    assert any(f.endswith((".png", ".pdf")) for f in made)


TOOL_ARGV = {
    "bench_wgs": ["out"], "bench_e2e": ["out"], "bench_kernels": [],
    "bench_v3_ab": [], "bench_multihost": ["out"], "quickstart": ["out"],
}


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_stress_scan_takes_no_device(device, tmp_path, monkeypatch, capsys):
    """``stress_scan`` runs no device code, so it has no ``--device``:
    argparse refuses the option before any work; nothing is written."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exc:
        stress_scan.main(["out", "1", "5000", "--device", device])
    assert exc.value.code == 2
    assert "--device" in capsys.readouterr().err
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("tool", sorted(TOOL_ARGV))
def test_device_cuda_raises_without_a_card(tool, tmp_path, monkeypatch):
    """``--device cuda`` (the default) raises before any work where no
    card is present; nothing is written."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(f"coral_tpu_torch.tools.{tool}")
    for argv in (TOOL_ARGV[tool], TOOL_ARGV[tool] + ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="is_available"):
            mod.main(argv)
    assert os.listdir(tmp_path) == []


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_bench_kernels_cuda_agree(cuda_device):
    """Both engines of the three hot loops on the card at small shapes
    (K3, K8, K9): every row agrees."""
    rows = _kernel_rows(("torch", "cuda"), cuda_device)
    assert len(rows) == 6 and all(r["agree"] for r in rows)


@pytest.mark.cuda
def test_bench_v3_ab_cuda_equals_torch(cuda_device):
    """K6, K2 and K1 through the tool on the card give the plain
    versions' sums."""
    keys = ("support_identical", "support_sum", "hitmask_sum")
    got = bench_v3_ab.run(1 << 16, engine="cuda", device=cuda_device)
    want = bench_v3_ab.run(1 << 16, engine="torch", device=cuda_device)
    assert got["support_identical"]
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
