"""Puts the benchmark's folders on the path and decides, inside a fixture,
whether a CUDA card is present."""
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


CPU = {"--device": "cpu", "--engine": "torch"}
