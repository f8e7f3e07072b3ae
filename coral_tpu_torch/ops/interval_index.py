"""An index over the interval table for the first-overlap lookup of K3 and
K4 (the 6-column route, ``csrc/pair6.cu``).

The function (``coral_tpu.ops.scoring.first_overlap``, in the TPU kernel
``_first_overlap_scan``)::

    io(c, a, b) = min k : ic[k] == c && is[k] <= b && ie[k] >= a   (-1: none)

with ``a, b`` a side's reference ends in storage order (``a > b`` on the
'-' strand: then it asks for containment of ``[b, a]``, the reference's
quirk, kept).  It is a 2-D dominance query for the smallest table index.
Both keys carry the chromosome in their high 32 bits::

    S[k] = ic[k] * 2^32 + is[k] + 2^31,   E[k] = ic[k] * 2^32 + ie[k] + 2^31
    X    = c * 2^32 + b + 2^31,           Y    = c * 2^32 + a + 2^31

and ``S[k] <= X && E[k] >= Y`` holds exactly when ``ic[k] == c``,
``is[k] <= b`` and ``ie[k] >= a`` (an interval of a lower chromosome fails
the second test, of a higher one the first).  So one index serves every
chromosome and assumes nothing of the table: intervals may overlap,
repeat, be empty (``is > ie``), come in any order, and carry any int32
chromosome code (pad rows -2, codes the 6-column meta word cannot hold).

The structure is a 4-ary merge-sort tree with cascaded counts.
Positions ``p = 0..n-1`` order the intervals by ``S`` (``ord[p]`` the
table index).  Level ``l`` (0..``top``, ``4^top >= n``) cuts the
positions into blocks of ``4^l``, each the union of four child blocks of
level ``l - 1``; a block's intervals stand in slots ordered by ``E``
descending (ties by position), and slot ``i`` holds eight int32,
``lev[l, i] = (mn, c0, c01, c012, m0, m01, m012, 0)``: over the block's
slots up to ``i``, ``mn`` the least table index, ``c0 .. c012`` how many
come from child 0, children 0-1 and children 0-2, and ``m0 .. m012`` the
least table index among those (``2^31 - 1`` where there are none).  A
query counts ``R`` (positions with ``S <= X``) and ``c`` (intervals with
``E >= Y``) by two binary searches, then walks from the root along ``R``:
in a block that ``R`` cuts inside child ``d``, the matches are the first
``c`` slots; those of children before ``d`` lie wholly below ``R`` and
the slot's ``m`` gives their least index, and the counts give child
``d``'s share of ``c`` to carry down.  So a step down is one load of 32
bytes, one sector: ``ceil(log4 n) + 1`` of them, besides the ``2 log2 n``
steps of the searches.  (A merge-sort tree that searched each block anew
takes ``log^2 n`` steps; a persistent segment tree ``log2 n`` dependent
loads through pointers, built an insertion at a time; the binary form of
this tree 15 levels at 8,200 intervals against these 8, and a second
load wherever a left half is taken whole.)  At 8,200 intervals the levels
take 2.1 MB, resident in the L2 cache.

:func:`build_interval_index` builds it on the CPU with
:func:`build_interval_index_torch`, the plain version, and on a card with
the kernels of ``csrc/index.cu``: a 4-ary merge sort of the start keys,
then the levels bottom up, each slot placed in its parent block by its
rank in its own child and a binary search in each of the other three.
The two give the same tensors, bit for bit.
:func:`first_overlap_indexed_torch` is the plain lookup.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from .scoring import as_tensor

_KEY_HI = 1 << 32
_KEY_BIAS = 1 << 31
FAN_BITS = 2              # 4 children a block
NONE = (1 << 31) - 1      # the m of a slot with no such interval


@dataclasses.dataclass(frozen=True)
class IntervalIndex:
    """The index of one int32 interval table of ``n`` rows (module
    docstring): ``skey`` int64 (n,) the start keys ascending, ``ekey``
    int64 (n,) the end keys descending (the root's slot order), ``lev``
    int32 (top + 1, n, 8) the levels' slots."""
    n: int
    top: int
    skey: torch.Tensor
    ekey: torch.Tensor
    lev: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.skey.device


def top_level(n: int) -> int:
    """The root's level: ``ceil(log4 n)``, 0 for ``n <= 1``."""
    return (max(n - 1, 0).bit_length() + FAN_BITS - 1) // FAN_BITS


def _check_table(int_chrom, int_start, int_end) -> int:
    n = int_chrom.shape[0]
    for t in (int_chrom, int_start, int_end):
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] != n:
            raise ValueError("int_chrom, int_start, int_end must be 1-D "
                             "int32 tensors of one length")
        if t.device != int_chrom.device:
            raise ValueError("int_chrom, int_start, int_end must be on one "
                             "device")
    return n


def _keys(chrom, x):
    return chrom.to(torch.int64) * _KEY_HI + x.to(torch.int64) + _KEY_BIAS


def build_interval_index_torch(int_chrom, int_start, int_end
                               ) -> IntervalIndex:
    """Plain version of the build, on the tables' device: each level's slot
    order by one sort of (block, rank of ``E``), the counts cumulative sums
    and the minima cumulative minima within the blocks."""
    n = _check_table(int_chrom, int_start, int_end)
    dev = int_chrom.device
    top = top_level(n)
    skey, order = torch.sort(_keys(int_chrom, int_start), stable=True)
    ends = _keys(int_chrom, int_end)[order]
    _, perm = torch.sort(ends, descending=True, stable=True)
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    rank = torch.empty_like(pos)
    rank[perm] = pos
    lev = torch.zeros((top + 1, n, 8), dtype=torch.int32, device=dev)
    for level in range(top + 1):
        block = pos >> (FAN_BITS * level)
        at = torch.argsort(block * n + rank)     # unique keys
        idx = order[at]
        # minima within blocks: blocks far apart in the high bits
        shift = block * _KEY_HI

        def block_min(values):
            return (torch.cummin(values - shift, 0).values
                    + shift).to(torch.int32)

        lev[level, :, 0] = block_min(idx)
        if level == 0:
            lev[level, :, 4:7] = NONE
            continue
        child = (at >> (FAN_BITS * (level - 1))) & 3
        first = block << (FAN_BITS * level)
        for d in range(3):
            below = (child <= d).to(torch.int64)
            run = torch.cumsum(below, 0)
            lev[level, :, 1 + d] = (run - run[first] + below[first]).to(
                torch.int32)
            lev[level, :, 4 + d] = block_min(torch.where(child <= d, idx,
                                                         NONE))
    return IntervalIndex(n, top, skey, ends[perm], lev)


def build_interval_index(int_chrom, int_start, int_end, device
                         ) -> IntervalIndex:
    """The index of an int32 interval table (numpy arrays or tensors) on
    ``device``.  On the CPU the plain version builds it; on a card the
    kernels of ``csrc/index.cu``, in one call of their C entry (one count
    under ``kernels.LAUNCHES["interval_index"]``)."""
    dev = resolve_device(device)
    ic, is_, ie = (as_tensor(t, dev, torch.int32)
                   for t in (int_chrom, int_start, int_end))
    n = _check_table(ic, is_, ie)
    if dev.type == "cpu":
        return build_interval_index_torch(ic, is_, ie)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    top = top_level(n)
    keys = torch.empty(2 * n, dtype=torch.int64, device=dev)
    lev = torch.empty((top + 1, n, 8), dtype=torch.int32, device=dev)
    index = IntervalIndex(n, top, keys[:n], keys[n:], lev)
    if n == 0:
        return index
    from .kernels import _launch    # kernels imports this module

    scratch = torch.empty(3 * n, dtype=torch.int64, device=dev)
    _launch("interval_index", "coral_interval_index_build", ic,
            ic.data_ptr(), is_.data_ptr(), ie.data_ptr(), n, top,
            index.skey.data_ptr(), index.ekey.data_ptr(), lev.data_ptr(),
            scratch.data_ptr())
    return index


def first_overlap_indexed_torch(index: IntervalIndex, chrom, a, b):
    """Plain lookup of ``io(chrom, a, b)`` for every query (module
    docstring), all queries a level at a time; int64 (q,), -1 where no
    interval matches.  Equal to ``coral_tpu.ops.scoring.first_overlap``
    over the table ``index`` was built from."""
    q = chrom.shape[0]
    n = index.n
    out = torch.full((q,), -1, dtype=torch.int64, device=chrom.device)
    if n == 0 or q == 0:
        return out
    hi = chrom.to(torch.int64) * _KEY_HI + _KEY_BIAS
    R = torch.searchsorted(index.skey, hi + b.to(torch.int64), right=True)
    # ekey descending: the count of keys >= Y
    c = n - torch.searchsorted(index.ekey.flip(0), hi + a.to(torch.int64))
    slots = index.lev.reshape(-1, 8).to(torch.int64)
    best = torch.full_like(R, NONE)
    base = torch.zeros_like(R)
    live = (R > 0) & (c > 0)
    for level in range(index.top, -1, -1):
        v = slots[torch.where(live, level * n + base + c - 1, 0)]
        whole = live & ((R >= base + (1 << (FAN_BITS * level))) | (R == n))
        best = torch.where(whole, torch.minimum(best, v[:, 0]), best)
        live = live & ~whole
        if level == 0:
            break
        sh = FAN_BITS * (level - 1)
        d = torch.where(live, (R - base) >> sh, 0)
        # children before d lie below R: their least index is m[d - 1]
        m = torch.gather(v[:, 3:7], 1, d[:, None])[:, 0]
        best = torch.where(live & (d > 0), torch.minimum(best, m), best)
        # child d's share of c: the counts through d less those before it
        upto = torch.cat([torch.zeros_like(c)[:, None], v[:, 1:4],
                          c[:, None]], 1)
        share = torch.gather(upto, 1, d[:, None] + 1)[:, 0] \
            - torch.gather(upto, 1, d[:, None])[:, 0]
        start = base + (d << sh)
        live = live & (R > start) & (share > 0)
        base = torch.where(live, start, base)
        c = torch.where(live, share, c)
    return torch.where(best < NONE, best, out)
