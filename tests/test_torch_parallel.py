"""The port's device-mesh layer (``coral_tpu_torch.parallel``) against the
JAX package's on its 8-device virtual CPU mesh: sharded pair scoring bit
for bit, sharded bin coverage exact in int64, the batch CN engine on a
mesh digit for digit, and ``--shard_devices`` through the CLI.  A mesh of
the port names the CPU as often as it needs shards."""
import filecmp
import math
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from __graft_entry__ import _synthetic_chimeras
from test_torch_cn_batch import _digits, _random_system
from test_torch_pairs import _table_with_nm
from coral_tpu.ops import coverage as jcov
from coral_tpu.ops import pairs as jp
from coral_tpu.parallel import make_mesh as jax_make_mesh
from coral_tpu.parallel import sharded as jsh
from coral_tpu_torch.graph import cn_solver
from coral_tpu_torch.ops import coverage as tcov
from coral_tpu_torch.ops import pairs as tp
from coral_tpu_torch.parallel import make_mesh, sharded
from coral_tpu_torch.parallel.mesh import Mesh, shard_bounds

CUTOFF, MIN_MAPQ, GAP = 100, 20, 100


def cpu_mesh(n: int) -> Mesh:
    return make_mesh(devices=["cpu"] * n)


def cpu_mesh_2d(n_dp: int, n_sp: int) -> Mesh:
    devs = np.empty(n_dp * n_sp, dtype=object)
    devs[:] = [torch.device("cpu")] * devs.size
    return Mesh(devs.reshape(n_dp, n_sp), ("dp", "sp"))


def jax_mesh_2d(n_dp: int, n_sp: int) -> JaxMesh:
    devs = np.asarray(jax.devices()[:n_dp * n_sp]).reshape(n_dp, n_sp)
    return JaxMesh(devs, ("dp", "sp"))


@pytest.fixture(scope="module")
def chimeras():
    return _synthetic_chimeras(n_reads=7 * 60 + 3, seed=1)


def test_mesh_shapes_and_devices():
    assert len(jax.devices()) == 8, "expected 8 virtual CPU devices"
    m = cpu_mesh(3)
    assert m.shape == {"dp": 3} and m.devices.shape == (3,)
    assert m.axis_names == ("dp",) and m.ranks is None
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert m.shard(dp=2) == (torch.device("cpu"), None)
    m2 = cpu_mesh_2d(2, 4)
    assert m2.shape == {"dp": 2, "sp": 4}
    assert m2.shard(sp=3)[0] == torch.device("cpu")
    with pytest.raises(ValueError, match="no mesh axis"):
        m2.shard(tp=0)
    with pytest.raises(ValueError, match="axis names"):
        Mesh(["cpu", "cpu"], ("dp", "sp"))
    assert make_mesh(2, devices=["cpu"] * 4).shape == {"dp": 2}
    with pytest.raises(RuntimeError, match="3 mesh device"):
        make_mesh(3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="unsupported device"):
        make_mesh(devices=["meta"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            make_mesh()
        with pytest.raises(RuntimeError):
            make_mesh(devices=["cpu", "cuda:0"])


@pytest.mark.parametrize("n,k", [(0, 3), (1, 8), (5, 4), (8, 8), (10_001, 8),
                                 (543, 3)])
def test_shard_bounds_are_the_padded_equal_blocks(n, k):
    """The blocks of a JAX shard_map over ``n`` rows padded to a multiple
    of ``k``, with the pad dropped."""
    pad = (-n) % k
    block = (n + pad) // k
    want = [(min(i * block, n), min((i + 1) * block, n)) for i in range(k)]
    got = shard_bounds(n, k)
    assert got == want
    assert sum(hi - lo for lo, hi in got) == n


@pytest.mark.parametrize("max_nm", [math.inf, 0.02])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
def test_score_pairs_sharded_equals_jax_and_single_device(chimeras, n_shards,
                                                          max_nm):
    chims, intervals = chimeras
    table = _table_with_nm(chims)
    jtable = jp.build_chimera_table(chims)
    jtable.nm = table.nm.copy()
    _, _, want = jsh.score_pairs_sharded(
        jtable, intervals, CUTOFF, MIN_MAPQ, GAP, jax_make_mesh(n_shards),
        max_nm=max_nm)
    _, _, single = tp.score_pairs_l(table, intervals, CUTOFF, MIN_MAPQ, GAP,
                                    max_nm, device="cpu")
    pi, pj, got = sharded.score_pairs_sharded(
        table, intervals, CUTOFF, MIN_MAPQ, GAP, cpu_mesh(n_shards),
        max_nm=max_nm, engine="torch")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, single)
    np.testing.assert_array_equal(pj, pi + 1)
    assert 0 < got.sum() < len(got)


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_score_pairs_sharded_gate_off_inf_nm_and_empty_shards(n_shards):
    """The JAX package's ``test_gate_off_sharded_agrees_on_inf_nm`` case:
    one pair whose first side carries inf per-base NM, gate off; at 3 and
    8 shards all but the first are empty."""
    from coral_tpu.ops.chimera import Chimera

    chims = {"inf0": Chimera(
        [[0, 999], [1005, 2004]],
        [["chr1", 1000, 2000, "+"], ["chr1", 1_200_000, 1_201_000, "+"]],
        [60, 60], [float("inf"), 0.01])}
    intervals = [["chr1", 0, 1_500_000], ["chr1", 1_600_000, 2_800_000],
                 ["chr2", 100_000, 2_500_000]]
    _, _, want = jsh.score_pairs_sharded(
        jp.build_chimera_table(chims), intervals, 100, 20, 100.0,
        jax_make_mesh(n_shards), max_nm=np.inf)
    table = tp.build_chimera_table(chims)
    _, _, got = sharded.score_pairs_sharded(
        table, intervals, 100, 20, 100.0, cpu_mesh(n_shards), max_nm=np.inf)
    assert got.tolist() == want.tolist() == [True]
    _, _, gated = sharded.score_pairs_sharded(
        table, intervals, 100, 20, 100.0, cpu_mesh(n_shards), max_nm=0.5)
    assert gated.tolist() == [False]


@pytest.mark.parametrize("long_list", [False, True], ids=["K1", "K3"])
def test_score_pairs_sharded_cuda_route_on_cpu_tensors(chimeras, long_list,
                                                       monkeypatch):
    """The ``cuda`` engine's blocks with its device check lifted, so that
    the kernels' wrappers take their plain versions on CPU tensors: the
    v3 route up to 8,190 intervals and the 6-column route above, whose
    interval index is built once for each distinct device of the mesh,
    not once a shard."""
    from coral_tpu_torch.ops import interval_index

    chims, intervals = chimeras
    if long_list:
        intervals = [["chr1", 1_000 * k, 1_000 * k + 500, 0]
                     for k in range(8190)] + intervals
    table = tp.build_chimera_table(chims)
    _, _, want = jp.score_pairs_l(jp.build_chimera_table(chims), intervals,
                                  CUTOFF, MIN_MAPQ, GAP, engine="numpy")
    builds = []
    real_build = interval_index.build_interval_index

    def counted(*args, **kw):
        builds.append(1)
        return real_build(*args, **kw)

    monkeypatch.setattr(tp, "_require_cuda", lambda dev: None)
    monkeypatch.setattr(interval_index, "build_interval_index", counted)
    mesh = make_mesh(devices=["cpu", "cpu:0", "cpu", "cpu:0", "cpu"])
    _, _, got = sharded.score_pairs_sharded(
        table, intervals, CUTOFF, MIN_MAPQ, GAP, mesh, engine="cuda")
    np.testing.assert_array_equal(got, want)
    assert len(builds) == (2 if long_list else 0)


def test_score_pairs_sharded_engines(chimeras):
    chims, intervals = chimeras
    table = tp.build_chimera_table(chims)
    with pytest.raises(ValueError, match="unknown engine"):
        sharded.score_pairs_sharded(table, intervals, CUTOFF, MIN_MAPQ, GAP,
                                    cpu_mesh(2), engine="numpy")
    with pytest.raises(ValueError, match="CUDA device"):
        sharded.score_pairs_sharded(table, intervals, CUTOFF, MIN_MAPQ, GAP,
                                    cpu_mesh(2), engine="cuda")
    assert sharded.resolve_mesh_engine("auto", cpu_mesh(2))[0] == "torch"
    assert sharded.resolve_mesh_engine("cuda", cpu_mesh(2))[0] == "cuda"
    with pytest.raises(ValueError, match="on the host"):
        sharded.resolve_mesh_engine("numpy", cpu_mesh(2))
    empty = tp.build_chimera_table({})
    pi, _, hits = sharded.score_pairs_sharded(empty, intervals, CUTOFF,
                                              MIN_MAPQ, GAP, cpu_mesh(3))
    assert pi.size == 0 and hits.size == 0


@pytest.mark.parametrize("as_table", [False, True])
def test_find_breakpoints_device_on_a_mesh(chimeras, as_table):
    """Rows (or BpTable columns) over a 3-shard mesh == the JAX package's
    on its mesh == the port's without one."""
    chims, intervals = chimeras
    args = (chims, intervals, CUTOFF, MIN_MAPQ, GAP)
    want = jp.find_breakpoints_device(*args, mesh=jax_make_mesh(3),
                                      as_table=as_table)
    single = tp.find_breakpoints_device(*args, engine="numpy",
                                        as_table=as_table, device="cpu")
    got = tp.find_breakpoints_device(*args, as_table=as_table, device="cpu",
                                     mesh=cpu_mesh(3))
    if as_table:
        for name in ("c1", "p1", "s1", "c2", "p2", "s2", "ridx", "ti", "tj",
                     "rgap", "flip", "q1", "q2"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(single, name))
        assert got.tup == want.tup == single.tup
        assert got.names == list(want.names) == single.names
        assert len(got) > 0
    else:
        assert got == want == single and len(got) > 0
    with pytest.raises(ValueError, match="on the host"):
        tp.find_breakpoints_device(*args, engine="numpy", device="cpu",
                                   mesh=cpu_mesh(2))


def _reads(n=10_001, seed=3):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, 1_000_000, n)      # odd count: padding
    return starts, starts + rng.integers(100, 20_000, n)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
def test_bin_coverage_sharded_1d(n_shards):
    s, e = _reads()
    want = jcov.bin_coverage_sharded(s, e, 0, 10_000, 110,
                                     jax_make_mesh(n_shards))
    single = tcov.bin_coverage(s, e, 0, 10_000, 110, device="cpu")
    got = tcov.bin_coverage_sharded(s, e, 0, 10_000, 110, cpu_mesh(n_shards),
                                    engine="torch")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, single)
    # reads reaching past the binned range, and an origin inside it
    got = tcov.bin_coverage_sharded(s, e, 250_000, 7_000, 64,
                                    cpu_mesh(n_shards))
    np.testing.assert_array_equal(
        got, tcov.bin_coverage(s, e, 250_000, 7_000, 64, device="cpu"))


@pytest.mark.parametrize("n_dp,n_sp", [(2, 2), (4, 2), (1, 2), (2, 1)])
@pytest.mark.parametrize("split_bins", [True, False])
def test_bin_coverage_sharded_2d(n_dp, n_sp, split_bins):
    s, e = _reads(n=4_099, seed=7)
    genome_axis = "sp" if split_bins else None
    want = jcov.bin_coverage_sharded(s, e, 40_000, 10_000, 110,
                                     jax_mesh_2d(n_dp, n_sp), "dp",
                                     genome_axis)
    got = tcov.bin_coverage_sharded(s, e, 40_000, 10_000, 110,
                                    cpu_mesh_2d(n_dp, n_sp), "dp",
                                    genome_axis)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, tcov.bin_coverage(s, e, 40_000, 10_000, 110, device="cpu"))


def test_bin_coverage_sharded_errors():
    s, e = _reads(n=10)
    with pytest.raises(ValueError, match="int32"):
        tcov.bin_coverage_sharded(s, e + 2**31, 0, 10, 4, cpu_mesh(2))
    with pytest.raises(ValueError, match="not divisible"):
        tcov.bin_coverage_sharded(s, e, 0, 10, 5, cpu_mesh_2d(2, 2),
                                  genome_axis="sp")
    with pytest.raises(ValueError, match="CUDA device"):
        tcov.bin_coverage_sharded(s, e, 0, 10, 4, cpu_mesh(2), engine="cuda")
    with pytest.raises(KeyError):
        tcov.bin_coverage_sharded(s, e, 0, 10, 4, cpu_mesh(2), axis="sp")
    none = tcov.bin_coverage_sharded(s[:0], e[:0], 0, 10, 4, cpu_mesh(3))
    assert none.dtype == np.int64 and not none.any()


@pytest.mark.parametrize("n_systems,n_shards", [(13, 1), (13, 3), (13, 4),
                                                (13, 8), (2, 8)])
def test_solve_cn_balance_batch_on_a_mesh(n_systems, n_shards):
    """Each shard solves its block of systems; every printed digit equals
    the unsharded batch's (blocks may be empty: 2 systems on 8 shards)."""
    rng = np.random.default_rng(43)
    systems = [_random_system(rng, int(k))
               for k in rng.integers(3, 30, n_systems)]
    want = cn_solver.solve_cn_balance_batch(systems, device="cpu")
    got = cn_solver.solve_cn_balance_batch(systems, mesh=cpu_mesh(n_shards))
    assert len(got) == len(want) == n_systems
    for x, w in zip(got, want):
        assert len(x) == len(w)
        assert _digits(x) == _digits(w)
        np.testing.assert_allclose(x, w, rtol=1e-12)
    with pytest.raises(ValueError, match="device= or mesh="):
        cn_solver.solve_cn_balance_batch(systems)


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    from coral_tpu_torch.sim import simulate_mixed_sample

    out = tmp_path_factory.mktemp("mesh_mixed")
    return out, *simulate_mixed_sample(str(out))


def test_compute_cn_batch_on_a_mesh(mixed):
    """The mixed sample's graphs: ``compute_cn_batch`` over 1 and 3 shards
    writes every CN digit of the unsharded batch."""
    import copy

    from coral_tpu_torch.io.bam import BamFile
    from coral_tpu_torch.reconstruct import Reconstruction

    _, bam, cns, seeds = mixed
    rec = Reconstruction(BamFile(bam), seeds, device="cpu")
    rec.read_cns(cns)
    rec.collect()
    rec.hash_to_segments()
    rec.find_amplicon_intervals()
    rec.find_smalldel_breakpoints()
    rec.find_breakpoints()
    rec.build_graph()
    rec.assign_cov()
    rec.bam.close()
    assert len(rec.graphs) >= 2

    def cn_digits(graphs):
        return [["%f" % e.cn for edges in (g.sequence_edges,
                                           g.concordant_edges,
                                           g.discordant_edges, g.source_edges)
                 for e in edges] for g in graphs]

    base = copy.deepcopy(rec.graphs)
    cn_solver.compute_cn_batch(base, rec.normal_cov, device="cpu")
    for n_shards in (1, 3):
        graphs = copy.deepcopy(rec.graphs)
        cn_solver.compute_cn_batch(graphs, rec.normal_cov,
                                   mesh=cpu_mesh(n_shards))
        assert cn_digits(graphs) == cn_digits(base)


def _reconstruct_cli(bam, seeds, cns, prefix, *extra):
    from coral_tpu_torch.cli import main

    assert main(["reconstruct", "--lr_bam", bam, "--cnv_seed", seeds,
                 "--cn_seg", cns, "--output_prefix", prefix,
                 "--device", "cpu", "--log_fn", prefix + ".log",
                 *extra]) == 0


def test_cli_shard_devices_reach_reconstruct_graphs(monkeypatch, tmp_path):
    """``--shard_devices 2 --device cpu`` lands as a 2-shard CPU mesh in
    ``reconstruct_graphs``; past the cards present it raises."""
    from coral_tpu_torch import cli
    import coral_tpu_torch.reconstruct as rmod

    seen = {}

    def fake_reconstruct_graphs(lr_bam, cnv_seed, cn_seg, output_prefix,
                                cfg=None, output_bp=False, scan_cache=False,
                                mesh=None, *, device):
        seen.update(cfg=cfg, mesh=mesh, device=device)

        class _Rec:
            class bam:
                @staticmethod
                def close():
                    pass
        return _Rec()

    monkeypatch.setattr(rmod, "reconstruct_graphs", fake_reconstruct_graphs)
    argv = ["reconstruct", "--lr_bam", "x.bam", "--cnv_seed", "s.bed",
            "--cn_seg", "c.cns", "--output_prefix", str(tmp_path / "o"),
            "--skip_cycle_decomp", "--log_fn", str(tmp_path / "log.txt")]
    cli.main(argv + ["--shard_devices", "2", "--device", "cpu",
                     "--engine", "torch", "--cn_engine", "batch"])
    mesh = seen["mesh"]
    assert mesh.shape == {"dp": 2} and mesh.ranks is None
    assert [str(d) for d in mesh.devices.flat] == ["cpu", "cpu"]
    assert seen["device"] == "cpu"
    assert seen["cfg"].engine.engine == "torch"
    cli.main(argv + ["--device", "cpu"])
    assert seen["mesh"] is None
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError):
        cli.main(argv + ["--shard_devices", str(n_cards + 1),
                         "--device", "cuda"])


def test_cli_shard_devices_writes_the_same_bytes(mixed, tmp_path):
    """The mixed sample through the CLI with ``--shard_devices 2 --device
    cpu`` (pair scoring on the 2-shard mesh; a mesh takes the batch CN
    engine, as in the JAX package) and without it under the same CN
    engine: the graph and cycles files are byte-identical, and the log
    shows the mesh's route.  The graph files also equal those of the run
    with neither (numpy CN); its cycles files print copy counts with
    ``repr``, where the batch and numpy CN engines part in the last bits
    (ROADMAP, divergences by design)."""
    _, bam, cns, seeds = mixed
    one = str(tmp_path / "one")
    two = str(tmp_path / "two")
    host = str(tmp_path / "host")
    _reconstruct_cli(bam, seeds, cns, one, "--engine", "torch",
                     "--cn_engine", "batch")
    _reconstruct_cli(bam, seeds, cns, two, "--engine", "torch",
                     "--shard_devices", "2")
    _reconstruct_cli(bam, seeds, cns, host, "--engine", "torch")
    outs = sorted(f for f in os.listdir(tmp_path) if f.startswith("one_")
                  and f.endswith(("_graph.txt", "_cycles.txt")))
    assert sum(f.endswith("_cycles.txt") for f in outs) >= 2
    for f in outs:
        assert filecmp.cmp(tmp_path / f, tmp_path / ("two" + f[3:]),
                           shallow=False), f
        if f.endswith("_graph.txt"):
            assert filecmp.cmp(tmp_path / f, tmp_path / ("host" + f[3:]),
                               shallow=False), f
    with open(two + ".log") as fh:
        log = fh.read()
    assert "mesh axis dp of 2" in log
    assert "CN balance route: engine=batch" in log
