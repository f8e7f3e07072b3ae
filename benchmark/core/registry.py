"""Everything a cell is made of, found by the names ``BENCHMARK.json`` gives:
``configs/<config>.json``, ``traffic/<traffic>.json`` and, for each
per-layer metric, the reader ``metrics/<name>.py``.  Adding a cell, a mix,
a configuration or a metric adds files and entries; no file here changes.

A mix needs no edit of the generator, the reference or the check where it
is an amplicon on one chromosome of the shapes ``traffic/generator.py``
reads: a one-segment circle (``amp``), or ``segments`` at their own extra
coverage with ``split`` junctions of any orientation, ``deletion``
junctions, spanning reads and the circles it plants (``circles``), so
long as those circles, with the chromosome's own walk where they leave a
path constraint unmet or under ``p_total_weight`` of the CN-weighted
length covered, are the decomposition (``reference/model.py``).  Where
the configuration decomposes cycles, any sample but a one-segment circle
is judged by ``coverage_rel_gap`` and ``cap_excess`` in place of
``copy_rel_gap``, so that configuration's ``check`` gives them limits.
Another chromosome, a second amplicon, or walks beyond those need code."""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    config_name: str
    traffic: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell(spec: dict, name: str, bench_dir: str = BENCH_DIR,
         root: str = ROOT) -> Cell:
    """The cell ``name`` with its configuration, mix and metrics."""
    by_name = {w["name"]: w for w in spec["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = by_name[name]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = _json(os.path.join(root, conf["file"]))
    mix = _json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json"))

    def reports(m):
        return "workloads" not in m or name in m["workloads"]

    e2e = [m for m in spec["end_to_end"] if reports(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if ("workloads" in m and name in m["workloads"])
                 or ("workloads" not in m and m["moves"] in names)]
    return Cell(name, w["config"], w["traffic"], int(w["chips"]), config, mix,
                e2e, per_layer)


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """The module ``metrics/<name>.py``: its ``SPANS`` (span name ->
    ``module:Qualified.name`` targets), ``SYNC`` (spans that end in a
    device synchronise), optional ``COUNTERS`` and its ``read(trace)``."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
