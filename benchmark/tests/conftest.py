"""Puts the benchmark's folders on the path and decides, inside a fixture,
whether a CUDA card is present."""
import copy
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH, os.path.join(BENCH, "core"),
          os.path.join(BENCH, "traffic"), os.path.join(BENCH, "reference")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def small_cell(name, **cut):
    """A cell of BENCHMARK.json with its mix cut to a size a CPU test
    holds: a 1.1 Mb domain, 40x more on the amplicon, 60 junction reads,
    100 kb CN rows; the same shapes.  ``cut`` changes more keys."""
    import registry

    c = registry.cell(registry.load_spec(ROOT), name)
    c.mix = dict(c.mix, domain=[54_400_000, 55_500_000], cn_row_bp=100_000,
                 amp_extra_cov=40, n_junction_reads=60, **cut)
    return c


def small_circle(amp_len=30_000, scale=0.5):
    """``full.gbm39`` run on the ``gbm39c`` mix (GBM39's whole circle) cut
    to a size a CPU test holds, its check with the limits of a sample of
    several walks: the three amplified segments ``amp_len`` long, their
    extra coverage and the junctions' reads times ``scale``, a domain of
    200 kb either side of the interval in 100 kb CN rows; every other
    segment, each junction's form and ends relative to its segments, the
    spanning reads and the background as the mix has them, so that the CN
    keeps its proportions and the decomposition its shape."""
    import generator

    c = small_cell("full.gbm39")
    m = copy.deepcopy(generator.load_mix("gbm39c"))
    old = [tuple(sg["at"]) for sg in m["segments"]]
    new, at = [], old[0][0]
    for sg, (s, e) in zip(m["segments"], old):
        new.append((at, at + (amp_len if sg["amplified"] else e - s)))
        at = new[-1][1]

    def move(x):
        (s, e), (s2, e2) = next(((s, e), n) for (s, e), n in zip(old, new)
                                if s <= x < e)
        return s2 + (x - s) if x - s < (e2 - s2) / 2 else e2 - (e - x)
    for sg, span in zip(m["segments"], new):
        sg["at"] = list(span)
        if sg["amplified"]:
            sg["extra_cov"] = round(sg["extra_cov"] * scale)
    for jn in m["junctions"]:
        jn["ends"] = [[move(p), o] for p, o in jn["ends"]]
        jn["reads"] = round(jn["reads"] * scale)
    for sp in m["spanning_reads"]:
        sp["starts"] = [move(x) for x in sp["starts"]]
    m.update(domain=[new[0][0] - 200_000, new[-1][1] + 200_000],
             cn_row_bp=100_000)
    c.mix = m
    c.config = dict(c.config, check=dict(
        c.config["check"], coverage_rel_gap=1e-9, cap_excess=1e-9))
    return c


# a mix of two amplified segments whose junctions take every orientation:
# a skip, a circle's closure, a turn back (- +) and two fold-backs
FOLDS = {
    "chrom": "chr7", "domain": [54_000_000, 55_000_000], "read_len": 9500,
    "bg_cov": 2, "cn_pad": [3000, 3000], "cn_row_bp": 100_000,
    "min_flank": 1000, "jitter": 2, "indel_unit": [19, 20],
    "qual_mean": 18, "qual_sd": 6,
    "segments": [{"at": [54_400_000, 54_500_000], "extra_cov": 20,
                  "amplified": True},
                 {"at": [54_600_000, 54_700_000], "extra_cov": 20,
                  "amplified": True}],
    "junctions": [
        {"ends": [[54_499_999, "+"], [54_600_000, "-"]], "reads": 19,
         "form": "split"},
        {"ends": [[54_610_000, "-"], [54_480_000, "+"]], "reads": 18,
         "form": "split"},
        {"ends": [[54_450_000, "+"], [54_650_000, "+"]], "reads": 17,
         "form": "split"},
        {"ends": [[54_420_000, "-"], [54_680_000, "-"]], "reads": 16,
         "form": "split"},
        {"ends": [[54_699_999, "+"], [54_400_000, "-"]], "reads": 15,
         "form": "split"}]}


CPU = {"--device": "cpu", "--engine": "torch"}
