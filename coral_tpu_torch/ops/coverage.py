"""Aligned-base coverage of reads over intervals and genome bins: the
counterpart of ``coral_tpu/ops/coverage.py``.

For reads [rs, re), define

    P(x) = sum_r clip(x - rs_r, 0, re_r - rs_r)
         = sum_{rs <= x} (x - rs)  -  sum_{re <= x} (x - re)

so the total overlap of any query interval is P(stop) - P(start): two
``searchsorted`` lookups against sorted endpoints with prefix sums
(:func:`.scoring.coverage_prefix_tables`, :func:`.scoring.coverage_prefix_eval`).
:class:`CoverageIndex` holds those tables on a device; everything is exact
int64.  The JAX module keeps an int32 residue and a float32 estimate and
recombines them on the host, because 64-bit integers are emulated on the
TPU; a GPU has them natively, so none of that is here.

:func:`bin_coverage` computes the genome-bin histogram straight from the
reads instead (the counterpart of ``bin_coverage_pallas``), with the
scatter kernel K8 (:func:`.kernels.bin_overlap`) or its plain version.

The sharded histogram of the JAX module (``bin_coverage_sharded``, reads
and bins split over a device mesh and merged with an integer sum) belongs
to the multi-device layer, which is not ported yet; there is no function
of that name here until it is.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .scoring import as_tensor, coverage_prefix_eval, coverage_prefix_tables


def _bin_edges(origin: int, bin_size: int, n_bins: int) -> np.ndarray:
    return origin + bin_size * np.arange(n_bins + 1, dtype=np.int64)


def _int32_range(starts, ends):
    """The reads as numpy arrays; raises, as the JAX module does, when a
    coordinate lies outside int32 (per-chromosome coordinates always fit;
    only a flat-genome caller trips this)."""
    s = np.asarray(starts)
    e = np.asarray(ends)
    i32 = np.iinfo(np.int32)
    if s.size and (int(e.max()) > i32.max or int(s.min()) < i32.min):
        raise ValueError("coordinates exceed int32; index per chromosome "
                         "instead")
    return s, e


class CoverageIndex:
    """Sorted-endpoint coverage index over aligned blocks or reads, on
    ``device``.  Queries take and return numpy arrays (int64)."""

    def __init__(self, starts, ends, *, device):
        s, e = _int32_range(starts, ends)
        self._device = resolve_device(device)
        self._tables = coverage_prefix_tables(
            as_tensor(s, self._device), as_tensor(e, self._device))
        self.n = int(s.shape[0])

    def prefix(self, xs) -> np.ndarray:
        """P(x) per query position."""
        x = as_tensor(np.asarray(xs, np.int64), self._device)
        return coverage_prefix_eval(self._tables, x).cpu().numpy()

    def interval_coverage(self, starts, ends) -> np.ndarray:
        """Total aligned-base overlap for each query interval [s, e)."""
        k = len(starts)
        p = self.prefix(np.concatenate([np.asarray(starts),
                                        np.asarray(ends)]))
        return p[k:] - p[:k]

    def bin_histogram(self, origin: int, bin_size: int,
                      n_bins: int) -> np.ndarray:
        """Aligned-base totals per genome bin."""
        p = self.prefix(_bin_edges(origin, bin_size, n_bins))
        return p[1:] - p[:-1]


def bin_coverage(starts, ends, origin: int, bin_size: int, n_bins: int, *,
                 engine: str = "torch", device) -> np.ndarray:
    """Aligned-base totals per genome bin, straight from int32 reads
    ``[starts, ends)``: int64 numpy (n_bins,), equal to
    ``CoverageIndex(starts, ends).bin_histogram(origin, bin_size, n_bins)``
    for reads with ``ends >= starts``.  A read with ``end < start`` counts
    nothing here (as in K8 and the TPU kernel) and negative in the prefix
    sums of ``CoverageIndex``.

    ``engine='torch'`` runs the plain version on ``device``;
    ``engine='cuda'`` launches the kernel K8 and needs a CUDA device."""
    if engine not in ("torch", "cuda"):
        raise ValueError(f"unknown engine {engine!r} (torch or cuda)")
    dev = resolve_device(device)
    if engine == "cuda" and dev.type != "cuda":
        raise ValueError(f"engine='cuda' needs a CUDA device, not {dev}")
    from .kernels import bin_overlap, bin_overlap_torch

    s, e = (as_tensor(a.astype(np.int32), dev)
            for a in _int32_range(starts, ends))
    fn = bin_overlap if engine == "cuda" else bin_overlap_torch
    return fn(s, e, int(origin), int(bin_size), int(n_bins)).cpu().numpy()
