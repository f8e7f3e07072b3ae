"""The port's ``seed``, ``cycle2bed``, ``plot`` and ``hsr`` modes
(``coral_tpu_torch.cli.main``) against the JAX package's
(``coral_tpu.cli.main``): the same arguments, each side in a directory of
its own, every file written byte-identical (a PDF with its
``/CreationDate`` taken out) and the same lines printed.  The argparse
options of each mode are the JAX package's, but for what ``reconstruct``
has of the port's own: its engines' choices, ``--device``, and no
``--shard_devices``.
"""
import os
import re

import pytest

from coral_tpu_torch.cli import build_parser as port_parser
from coral_tpu_torch.cli import main as port_main


@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    """The simulated ecDNA sample (with integration reads, as
    ``tests/test_cli.py`` makes it) and the three-class mixed sample, each
    with the JAX package's graph and cycles files."""
    import dataclasses

    from coral_tpu.config import DEFAULT_CONFIG
    from coral_tpu.reconstruct import reconstruct_cycles, reconstruct_graphs
    from coral_tpu.sim import simulate_ecdna, simulate_mixed_sample

    cfg = DEFAULT_CONFIG.replace(engine=dataclasses.replace(
        DEFAULT_CONFIG.engine, engine="numpy", cn_engine="numpy"))
    out = {}
    for name, make in (
            ("ecdna", lambda d: simulate_ecdna(d, jitter=0,
                                               n_integration_reads=15)),
            ("mixed", lambda d: simulate_mixed_sample(d, seed=3))):
        d = str(tmp_path_factory.mktemp(name))
        bam, cns, seeds = make(d)
        prefix = os.path.join(d, "p")
        rec = reconstruct_graphs(bam, seeds, cns, prefix, cfg=cfg)
        reconstruct_cycles(rec, prefix)
        rec.bam.close()
        out[name] = dict(bam=bam, cns=cns, prefix=prefix, dir=d)
    return out


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, names in os.walk(d) for f in names)


def _content(path):
    with open(path, "rb") as fh:
        data = fh.read()
    if path.endswith(".pdf"):
        data = re.sub(rb"/CreationDate \([^)]*\)", b"", data)
    return data


def _both(tmp_path, monkeypatch, capsys, argv, inputs=None):
    """``argv(d)`` through each ``main`` in turn, with the working
    directory ``d`` at ``tmp_path/work`` (``inputs`` maps file names
    written there first to their bytes), which then moves to
    ``tmp_path/<side>``: both runs see the same paths, which the plots
    print in their titles.  The two directories must end up with the same
    files, byte for byte, and the two runs must print the same lines.
    Returns the files."""
    from coral_tpu.cli import main as jax_main

    d = tmp_path / "work"
    printed = {}
    for side, main in (("jax", jax_main), ("port", port_main)):
        d.mkdir()
        for name, data in (inputs or {}).items():
            (d / name).write_bytes(data)
        monkeypatch.chdir(d)
        capsys.readouterr()
        assert main(argv(str(d))) == 0
        printed[side] = capsys.readouterr().out
        monkeypatch.chdir(tmp_path)
        d.rename(tmp_path / side)
    dj, dp = str(tmp_path / "jax"), str(tmp_path / "port")
    out_j, out_p = printed["jax"], printed["port"]
    names = _files(dj)
    assert names and names == _files(dp)
    for n in names:
        assert _content(os.path.join(dj, n)) == \
            _content(os.path.join(dp, n)), n
    assert out_j == out_p
    return names


def _bed(segments):
    return "".join(f"{c}\t{s}\t{e}\t{cn}\n"
                   for c, s, e, cn in segments).encode()


CHR7_Q = 62_100_000     # the end of chr7's centromere
# the segment sets of tests/test_seed.py, as CN .bed files
SEED_BEDS = {
    "one segment on the q arm": [("chr7", 63_000_000, 63_500_000, 30.0)],
    "too small": [("chr7", 63_000_000, 63_050_000, 30.0)],
    "gap merged": [("chr7", 63_000_000, 63_100_000, 30.0),
                   ("chr7", 63_300_000, 63_400_000, 30.0)],
    "gap not merged": [("chr7", 63_000_000, 63_150_000, 30.0),
                       ("chr7", 63_550_000, 63_700_000, 30.0)],
    "arm background": [("chr7", CHR7_Q, CHR7_Q + 60_000_000, 5.9),
                       ("chr7", CHR7_Q + 60_000_000, CHR7_Q + 60_500_000,
                        10.0)],
    "large aggregate": [("chr7", CHR7_Q + 1_000_000, CHR7_Q + 7_000_000, 7.0),
                        ("chr7", CHR7_Q + 7_000_000, CHR7_Q + 7_200_000,
                         8.0)],
    "non-qualifying inside a run": [("chr7", 63_000_000, 63_100_000, 30.0),
                                    ("chr7", 63_100_000, 63_250_000, 2.0),
                                    ("chr7", 63_250_000, 63_350_000, 30.0)],
}


@pytest.mark.parametrize("case", sorted(SEED_BEDS))
def test_seed_on_the_seed_fixtures(case, tmp_path, monkeypatch, capsys):
    _both(tmp_path, monkeypatch, capsys,
          lambda d: ["seed", "--cn_seg", "cn.bed", "--out", "seeds.bed"],
          {"cn.bed": _bed(SEED_BEDS[case])})


def test_seed_on_a_cns_with_flags(tmp_path, monkeypatch, capsys):
    """The CNVkit fixture of ``tests/test_cli.py``, the output named from
    the input, and every threshold flag."""
    cns = b"chromosome\ts\te\tg\tl\nchr7\t63000000\t63500000\t-\t3.9\n"
    names = _both(tmp_path, monkeypatch, capsys,
                  lambda d: ["seed", "--cn_seg", "s.cns", "--gain", "5.5",
                             "--min_seed_size", "100000",
                             "--max_seg_gap", "300000"],
                  {"s.cns": cns})
    assert "s_CNV_SEEDS.bed" in names


@pytest.mark.parametrize("sim", ["ecdna", "mixed"])
def test_seed_on_the_sims(sim, sims, tmp_path, monkeypatch, capsys):
    with open(sims[sim]["cns"], "rb") as fh:
        cns = fh.read()
    names = _both(tmp_path, monkeypatch, capsys,
                  lambda d: ["seed", "--cn_seg", "sim.cns"],
                  {"sim.cns": cns})
    with open(tmp_path / "port" / "sim_CNV_SEEDS.bed") as fh:
        assert fh.read().strip(), names


@pytest.mark.parametrize("flags", [[], ["--rotate_to_min"],
                                   ["--num_cycles", "1"],
                                   ["--rotate_to_min", "--num_cycles", "2"]],
                         ids=["plain", "rotate", "first", "rotate first two"])
@pytest.mark.parametrize("sim", ["ecdna", "mixed"])
def test_cycle2bed(sim, flags, sims, tmp_path, monkeypatch, capsys):
    cycles = sorted(f for f in os.listdir(sims[sim]["dir"])
                    if f.endswith("_cycles.txt"))
    assert cycles
    for i, name in enumerate(cycles):
        sub = tmp_path / str(i)
        sub.mkdir()
        _both(sub, monkeypatch, capsys,
              lambda d: ["cycle2bed", "--cycle_fn",
                         os.path.join(sims[sim]["dir"], name),
                         "--output_fn", "cycles.bed", *flags])


PLOTS = {
    "graph": ["--plot_graph", "--bam", "{bam}", "--graph",
              "{prefix}_amplicon1_graph.txt"],
    "cycles": ["--plot_cycles", "--cycles", "{prefix}_amplicon1_cycles.txt"],
    "graph, region": ["--plot_graph", "--bam", "{bam}", "--graph",
                      "{prefix}_amplicon1_graph.txt", "--region",
                      "chr7:55000000-55200000"],
    "cycles, cyclic only": ["--plot_cycles", "--graph",
                            "{prefix}_amplicon1_graph.txt", "--cycles",
                            "{prefix}_amplicon1_cycles.txt",
                            "--only_cyclic_paths"],
}


@pytest.mark.parametrize("case", sorted(PLOTS))
def test_plot(case, sims, tmp_path, monkeypatch, capsys):
    sim = sims["ecdna"]
    flags = [a.format(**sim) for a in PLOTS[case]]
    names = _both(tmp_path, monkeypatch, capsys,
                  lambda d: ["plot", "--ref", "GRCh38", "--output_prefix",
                             "vis", *flags])
    assert any(n.endswith(".png") for n in names)
    if "--plot_graph" in flags:
        assert "vis_graph.pdf" in names


@pytest.mark.parametrize("where", ["relative", "absolute"])
def test_hsr(where, sims, tmp_path, monkeypatch, capsys):
    """The integration sites of the ecDNA sample's integration reads, from
    its cycles file (converted to a bed in the output, a text file) with
    a relative prefix and an absolute one, as ``tests/test_cli.py``
    drives it."""
    sim = sims["ecdna"]

    def argv(d):
        prefix = "hsrtest" if where == "relative" else \
            os.path.join(d, "deep", "hsrabs")
        os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
        return ["hsr", "--lr_bam", sim["bam"], "--cycles",
                sim["prefix"] + "_amplicon1_cycles.txt",
                "--cn_seg", sim["cns"], "--output_prefix", prefix,
                "--normal_cov", "20"]

    names = _both(tmp_path, monkeypatch, capsys, argv)
    assert any(n.endswith(".png") for n in names)
    assert any(n.endswith("converted_cycles.bed") for n in names)


def _options(parser):
    """mode -> {option strings: what argparse holds of the option}."""
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    return {mode: {tuple(a.option_strings): dict(
        dest=a.dest, default=a.default, type=a.type, required=a.required,
        nargs=a.nargs, choices=a.choices, help=a.help,
        action=type(a).__name__) for a in p._actions}
        for mode, p in sub.choices.items()}


def test_option_sets_match():
    from coral_tpu.cli import build_parser as jax_parser

    port, jax_ = _options(port_parser()), _options(jax_parser())
    assert sorted(port) == sorted(jax_) == sorted(
        ["seed", "reconstruct", "hsr", "plot", "cycle2bed"])
    for mode in ("seed", "hsr", "plot", "cycle2bed"):
        assert port[mode] == jax_[mode], mode
    rp, rj = dict(port["reconstruct"]), dict(jax_["reconstruct"])
    assert set(rp) - set(rj) == {("--device",)}
    assert set(rj) - set(rp) == {("--shard_devices",)}
    for opt in rj.keys() & rp.keys():
        skip = {"help"}
        if opt in (("--engine",), ("--cn_engine",)):
            skip.add("choices")
        assert {k: v for k, v in rp[opt].items() if k not in skip} == \
            {k: v for k, v in rj[opt].items() if k not in skip}, opt
    assert rp[("--cn_engine",)]["choices"] == ["auto", "numpy", "torch",
                                               "batch"]
