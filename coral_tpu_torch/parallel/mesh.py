"""Device meshes for data-parallel read scoring: the port of
``coral_tpu/parallel/mesh.py``.

A :class:`Mesh` is an ndarray of ``torch.device`` with a name for each of
its axes, as a ``jax.sharding.Mesh`` is one of JAX devices:
``mesh.shape[axis]`` is the number of shards along ``axis``.  Sharded
functions give shard ``k`` of an axis a contiguous block of the work and
run it on that shard's device; integer merges in shard order make any
shard count give the single-device result exactly.

A mesh may name one device more than once.  That is how the CPU tests
get eight shards out of one CPU (the JAX tests force eight virtual CPU
devices instead) and how one card runs two or four shards.  A mesh built
by :func:`coral_tpu_torch.parallel.distributed.global_mesh` spans the
processes of a ``torch.distributed`` group and says which rank owns each
entry (``ranks``); every other mesh lives in one process.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device


class Mesh:
    """``devices``: an ndarray (any shape) of ``torch.device``;
    ``axis_names``: one name per dimension; ``ranks``: None for a mesh of
    this process, else an int array of the same shape naming the rank of
    the ``torch.distributed`` group that owns each entry."""

    def __init__(self, devices, axis_names: Sequence[str], ranks=None):
        given = np.asarray(devices, dtype=object)
        self.devices = np.empty(given.size, dtype=object)
        self.devices[:] = [torch.device(d) for d in given.flat]
        self.devices = self.devices.reshape(given.shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim \
                or len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names {self.axis_names} do not name the "
                             f"{self.devices.ndim} axes of the mesh once each")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.ranks = None if ranks is None else \
            np.asarray(ranks, np.int64).reshape(self.devices.shape)

    def shard(self, **coords) -> tuple:
        """(device, rank) of the entry at ``{axis: index}``; an axis not
        named takes index 0 (its shards hold replicas)."""
        idx = tuple(coords.pop(a, 0) for a in self.axis_names)
        if coords:
            raise ValueError(f"no mesh axis {sorted(coords)}")
        return (self.devices[idx],
                None if self.ranks is None else int(self.ranks[idx]))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp", *,
              devices=None) -> Mesh:
    """A 1-D mesh over ``axis``.  By default every CUDA device (raises when
    there is none); ``n_devices`` takes the first that many, and raises
    when fewer are present.  ``devices`` names the devices instead, each
    resolved by :func:`coral_tpu_torch.device.resolve_device` (a CUDA
    device that is not there raises) and any of them more than once."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() takes the CUDA devices and "
                               "torch.cuda.is_available() is False; pass "
                               "devices= for a mesh of other devices")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    if n_devices is not None:
        if not 1 <= n_devices <= len(devs):
            raise RuntimeError(f"{n_devices} mesh device(s) asked for, "
                               f"{len(devs)} present")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devs, (axis,))


def shard_bounds(n: int, n_shards: int) -> list:
    """The ``[lo, hi)`` rows of each of ``n_shards`` contiguous blocks of
    ``n`` rows, as a JAX shard_map splits them: ``n`` padded to a multiple
    of ``n_shards``, equal blocks of the padded rows, the pad dropped (the
    last blocks are short or empty)."""
    block = -(-n // n_shards) if n else 0
    return [(min(k * block, n), min((k + 1) * block, n))
            for k in range(n_shards)]
