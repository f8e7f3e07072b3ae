"""Data-parallel pair scoring over a device mesh: the port of
``coral_tpu/parallel/sharded.py``.

Pair predicates are embarrassingly parallel: shard ``k`` of the mesh axis
scores the ``k``-th contiguous block of the adjacent pairs on its own
device, and the hit masks concatenate in shard order, so any shard count
gives :func:`coral_tpu_torch.ops.pairs.score_pairs_l`'s mask bit for bit.
On a mesh that spans the processes of a ``torch.distributed`` group
(:func:`coral_tpu_torch.parallel.distributed.global_mesh`) each rank
scores its own blocks and an all-gather rebuilds the mask, in rank order,
on every rank.  Coverage histograms merge by an integer sum instead
(:func:`coral_tpu_torch.ops.coverage.bin_coverage_sharded`).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..ops.pairs import ChimeraTable, adjacent_pair_indices, make_pair_scorer
from .mesh import shard_bounds


def resolve_mesh_engine(engine: str, mesh) -> Tuple[str, str]:
    """The engine that scores the blocks of a mesh, with the reason:
    ``auto`` is ``cuda`` when every device of the mesh is a CUDA device and
    ``torch`` otherwise.  ``numpy`` raises: it scores on the host, and a
    mesh asks for its devices."""
    if engine in ("torch", "cuda"):
        return engine, "forced"
    if engine == "numpy":
        raise ValueError("engine 'numpy' scores on the host; a mesh scores "
                         "on its devices (engine torch, cuda or auto)")
    if engine != "auto":
        raise ValueError(f"unknown engine {engine!r} (auto, torch, cuda)")
    if all(d.type == "cuda" for d in mesh.devices.flat):
        return "cuda", "every mesh device is a CUDA device"
    return "torch", "a mesh device is not a CUDA device"


def score_pairs_sharded(
    table: ChimeraTable,
    intervals: List[list],
    min_bp_match_cutoff: int,
    min_mapq: float,
    gap_: float,
    mesh,
    axis: str = "dp",
    max_nm: float = np.inf,
    *,
    engine: str = "torch",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Adjacent-pair predicate evaluation sharded over ``axis`` of
    ``mesh``.  Returns (pair_i, pair_j, hits) identical to
    ``ops.pairs.score_pairs_l`` for any mesh size.

    The pairs split as the JAX module splits them (padded to a multiple of
    the shard count, equal blocks; the pad is dropped, so the last blocks
    may be short or empty).  ``engine`` scores each block on its shard's
    device: ``torch`` (the 14-column predicate, with the NM gate) or
    ``cuda`` (K1 up to ``MAX_PACKED2_INTERVALS`` intervals, K3 above; a
    finite ``max_nm`` goes to ``torch``, as in ``score_pairs_l``).  What a
    block would redo is done once for each device of the mesh: the
    interval table on it and K3's interval index.  The NM gate-off
    contract (zero NM and an infinite cutoff when ``max_nm`` is infinite)
    is that of ``score_pairs_l``."""
    if engine not in ("torch", "cuda"):
        raise ValueError(f"unknown engine {engine!r} on a mesh (torch or "
                         "cuda)")
    pi, pj = adjacent_pair_indices(table.read_off)
    if pi.size == 0:
        return pi, pj, np.zeros(0, bool)
    bounds = shard_bounds(pi.size, mesh.shape[axis])
    shards = [mesh.shard(**{axis: k}) for k in range(len(bounds))]
    me = None
    if mesh.ranks is not None:
        import torch.distributed as dist

        me = dist.get_rank()
    scorers = {}

    def score(k: int) -> np.ndarray:
        (lo, hi), (dev, _) = bounds[k], shards[k]
        if hi == lo:
            return np.zeros(0, bool)
        if dev not in scorers:
            scorers[dev] = make_pair_scorer(
                table, intervals, min_bp_match_cutoff, min_mapq, gap_,
                max_nm, engine, device=dev)
        return scorers[dev](pi[lo:hi])

    if me is None:
        return pi, pj, np.concatenate([score(k) for k in range(len(bounds))])
    # a mesh over the processes of a group: this rank's blocks, gathered
    # by rank and laid back in shard order
    from .distributed import allgather_bytes

    mine = [k for k, (_, rank) in enumerate(shards) if rank == me]
    local = np.concatenate([score(k) for k in mine] + [np.zeros(0, bool)])
    parts = [np.frombuffer(b, bool) for b in allgather_bytes(local.tobytes())]
    taken = [0] * len(parts)
    blocks = []
    for (lo, hi), (_, rank) in zip(bounds, shards):
        blocks.append(parts[rank][taken[rank]:taken[rank] + hi - lo])
        taken[rank] += hi - lo
    return pi, pj, np.concatenate(blocks)
