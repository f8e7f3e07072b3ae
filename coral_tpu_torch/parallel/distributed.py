"""Multi-process runs on ``torch.distributed``: the port of
``coral_tpu/parallel/distributed.py``.

One process per BAM shard, each ingesting its own shard
(:mod:`.multihost`), with integer reductions and byte gathers over the
process group's collectives:

* :func:`initialize` brings this process into the group.  The backend is
  the caller's choice and is never switched: ``gloo`` on CPUs (a rank may
  still compute on a card; its collectives then go through host memory,
  which is gloo's transport), ``nccl`` with one card per process (two
  ranks on one card raise);
* :func:`global_mesh`, a 1-D mesh with one entry per rank, each on that
  rank's device;
* :func:`allreduce_sum`, the int64 sum of one array from every process
  (order-invariant, so any process count gives the single-process
  result bit for bit); with nccl it stays on the card;
* :func:`allgather_bytes`, one payload from every process, in process
  order;
* :class:`DistributedShardBam`, :func:`distributed_reconstruct_graphs`,
  the whole pipeline with pair scoring sharded over the global mesh, and
  :func:`shard_bin_histogram`, the per-process genome-bin histogram (K8 on
  a card).

``tests/test_torch_distributed.py`` spawns real groups (gloo, a ``file://``
rendezvous) and holds every process's histogram and output files to the
single-process run on the unsplit BAM.

Run a worker by hand, one per rank (``init_method`` e.g.
``file:///tmp/rdzv`` or ``tcp://localhost:29500``; ``device`` ``cpu`` or
``cuda:N``)::

    python -m coral_tpu_torch.parallel.distributed <rank> <world>
        <init_method> <backend> <device> <shard.bam> <chrom> <origin>
        <bin_size> <n_bins> <out.npy>
    python -m coral_tpu_torch.parallel.distributed pipeline <rank> <world>
        <init_method> <backend> <device> <cnv_seed> <cn_seg> <prefix>
        <shard0> <shard1> ...
"""
from __future__ import annotations

import pickle
import socket
import sys

import numpy as np
import torch

from ..device import resolve_device
from .mesh import Mesh

# this process's device in the group, set by initialize (the group itself
# is torch.distributed's own per-process state)
_LOCAL: dict = {}


def initialize(init_method: str, world_size: int, rank: int, *,
               backend: str, device) -> None:
    """Join the process group as ``rank`` of ``world_size``, computing on
    ``device``.  ``backend`` ``gloo`` takes any device; ``nccl`` needs a
    CUDA device and raises when another rank is on the same card."""
    import torch.distributed as dist

    dev = resolve_device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"backend nccl needs a CUDA device, not {dev}")
        dev = torch.device("cuda", torch.cuda.current_device()
                           if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    elif backend != "gloo":
        raise ValueError(f"unknown backend {backend!r} (gloo or nccl)")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    if backend == "nccl":
        # before any nccl collective: a card shared by two ranks would
        # fail (or hang) inside the communicator instead of here
        group = dist.new_group(backend="gloo")
        ids = [None] * world_size
        dist.all_gather_object(ids, _card_id(dev), group=group)
        dist.destroy_process_group(group)
        try:
            check_one_card_per_rank(ids)
        except RuntimeError:
            dist.destroy_process_group()
            raise
    _LOCAL["device"] = dev


def _card_id(dev: torch.device) -> str:
    props = torch.cuda.get_device_properties(dev)
    return f"{socket.gethostname()}/{getattr(props, 'uuid', dev.index)}"


def check_one_card_per_rank(card_ids) -> None:
    """Raise when two ranks name the same card (``card_ids`` in rank
    order)."""
    seen: dict = {}
    for rank, cid in enumerate(card_ids):
        if cid in seen:
            raise RuntimeError(
                f"backend nccl needs one card per process: ranks "
                f"{seen[cid]} and {rank} are both on card {cid}")
        seen[cid] = rank


def local_device() -> torch.device:
    """This process's device in the group (:func:`initialize`)."""
    if "device" not in _LOCAL:
        raise RuntimeError("not in a process group: call initialize()")
    return _LOCAL["device"]


def _comm_device() -> torch.device:
    import torch.distributed as dist

    return local_device() if dist.get_backend() == "nccl" \
        else torch.device("cpu")


def global_mesh(axis: str = "dp") -> Mesh:
    """1-D mesh over the group: entry ``r`` is rank ``r``'s device."""
    import torch.distributed as dist

    devs = [None] * dist.get_world_size()
    dist.all_gather_object(devs, str(local_device()))
    return Mesh(devs, (axis,), ranks=range(len(devs)))


def allreduce_sum(local) -> np.ndarray:
    """Elementwise int64 sum over every process's ``local`` (one shape on
    all), identical on every process."""
    import torch.distributed as dist

    t = torch.from_numpy(np.ascontiguousarray(local, np.int64)) \
        .to(_comm_device())
    dist.all_reduce(t)
    return t.cpu().numpy()


def allgather_bytes(payload: bytes) -> list:
    """One ``payload`` from every process -> the list of them in process
    order, on every process: the lengths are gathered first, then the
    payloads padded to the longest."""
    import torch.distributed as dist

    dev = _comm_device()
    world = dist.get_world_size()
    n = torch.tensor([len(payload)], dtype=torch.int64, device=dev)
    lens = [torch.empty_like(n) for _ in range(world)]
    dist.all_gather(lens, n)
    lens = [int(x) for x in lens]
    buf = torch.zeros(max(max(lens), 1), dtype=torch.uint8, device=dev)
    if payload:
        buf[:len(payload)] = torch.frombuffer(bytearray(payload),
                                              dtype=torch.uint8)
    outs = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(outs, buf)
    return [o[:k].cpu().numpy().tobytes() for o, k in zip(outs, lens)]


def _allgather_obj(obj) -> list:
    """Pickle-based object gather (process order); every payload comes
    from a process of this program's group."""
    return [pickle.loads(b) for b in allgather_bytes(pickle.dumps(obj))]


class DistributedShardBam:
    """BamFile-compatible view for a group in which each process holds ONE
    shard: every region query reduces across processes with the merge
    math of ``multihost.MultiShardBam``, integer sums for coverage and
    counts, process-order gathers (= shard order, since process p ingests
    shard p of the contiguous split) for record rows.  Every process must
    issue the same query sequence (they do: the pipeline host code is
    replicated after the scan merge)."""

    scan_from_cache = False

    def __init__(self, shard_path: str):
        from ..io.bam import BamFile

        self.local = BamFile(shard_path)

    def coverage_sum(self, chrom, start, stop, **kw) -> int:
        local = [self.local.coverage_sum(chrom, start, stop, **kw)]
        return int(allreduce_sum(local)[0])

    def coverage_profile(self, chrom, start, stop, **kw) -> np.ndarray:
        return allreduce_sum(
            self.local.coverage_profile(chrom, start, stop, **kw))

    def read_count(self, chrom, start, stop) -> int:
        return int(allreduce_sum([self.local.read_count(chrom, start,
                                                        stop)])[0])

    def names_overlapping(self, chrom, start, stop) -> set:
        out: set = set()
        for part in _allgather_obj(
                sorted(self.local.names_overlapping(chrom, start, stop))):
            out.update(part)
        return out

    def del_gap_alignments(self, *args, **kw) -> list:
        rows: list = []
        for part in _allgather_obj(self.local.del_gap_alignments(*args,
                                                                 **kw)):
            rows.extend(part)
        return rows

    def region_records(self, chrom, start, stop):
        for part in _allgather_obj(
                list(self.local.region_records(chrom, start, stop))):
            yield from part

    def close(self) -> None:
        self.local.close()


def distributed_reconstruct_graphs(
        shard_paths, cnv_seed: str, cn_seg: str, output_prefix: str,
        cfg=None, mesh=None, axis: str = "dp", run_cycles: bool = True):
    """The whole pipeline in an initialized group, one process per BAM
    shard, on this process's device (:func:`local_device`):

    1. each process scans ITS shard (``multihost.scan_shard``);
    2. the scan products gather in process order and merge with
       ``multihost.merge_scan_parts`` (process p owns shard p of the
       contiguous split, so process order is shard order); the
       primary-length rescue screens each shard and merges first-wins;
    3. pair scoring is sharded over the global mesh
       (``sharded.score_pairs_sharded``: each rank scores its block, an
       all-gather rebuilds the mask in rank order);
    4. coverage and read-count queries sum across processes
       (:class:`DistributedShardBam`);
    5. every process builds the same graphs and writes the same files.

    Returns the Reconstruction."""
    import torch.distributed as dist

    from ..config import DEFAULT_CONFIG
    from ..graph.breakpoint_graph import write_graph_file
    from ..reconstruct import Reconstruction
    from .multihost import (_rescue_read_lengths, decode_chimeras,
                            merge_scan_parts, scan_shard)

    cfg = cfg or DEFAULT_CONFIG
    mesh = mesh or global_mesh(axis)
    shard = shard_paths[dist.get_rank()]

    parts = _allgather_obj(scan_shard(shard))
    read_length, sa_buckets, nm_stats = merge_scan_parts(parts)
    # each process screens ITS shard; the first process (= first shard)
    # wins, as in the sequential multi-shard scan
    missing = [rn for rn in sa_buckets if rn not in read_length]
    bam = DistributedShardBam(shard)
    local_rescued = _rescue_read_lengths([bam.local], missing)
    for rescued in _allgather_obj(local_rescued):
        for rn, ql in rescued.items():
            if rn not in read_length:
                read_length[rn] = ql
    chimeras = decode_chimeras(read_length, sa_buckets)

    rec = Reconstruction(bam, cnv_seed, cfg, device=local_device())
    rec.read_cns(cn_seg)
    rec.read_length = read_length
    rec.chimeras = chimeras
    rec.nm_stats = nm_stats
    rec.hash_to_segments()
    rec.find_amplicon_intervals()
    rec.find_smalldel_breakpoints()
    rec.find_breakpoints(mesh=mesh)
    rec.build_graph()
    rec.assign_cov()
    rec.compute_cn()
    for gi, g in enumerate(rec.graphs):
        write_graph_file(g, f"{output_prefix}_amplicon{gi + 1}_graph.txt")
    if run_cycles:
        from ..reconstruct import reconstruct_cycles

        reconstruct_cycles(rec, output_prefix)
    return rec


def shard_bin_histogram(shard_path: str, chrom: str, origin: int,
                        bin_size: int, n_bins: int) -> np.ndarray:
    """Per-process ingest step: scan one BAM shard, count its aligned bases
    per genome bin on this process's device (K8 on a card, its plain
    version on a CPU) and return the GLOBAL histogram (int64, summed over
    the group, identical on every process)."""
    from ..io.bam import BamFile
    from ..ops.coverage import bin_coverage

    dev = local_device()
    bam = BamFile(shard_path)
    try:
        rid = bam.rid(chrom)
        if rid < 0 or rid not in bam._ref_slices:
            local = np.zeros(n_bins, np.int64)
        else:
            s, e = bam._ref_slices[rid]
            local = bin_coverage(
                bam.pos[s:e], bam.end[s:e], origin, bin_size, n_bins,
                engine="cuda" if dev.type == "cuda" else "torch",
                device=dev)
    finally:
        bam.close()
    return allreduce_sum(local)


def _join(argv) -> list:
    """``<rank> <world> <init_method> <backend> <device> rest...`` ->
    rest, this process in the group."""
    rank, world = int(argv[0]), int(argv[1])
    initialize(argv[2], world, rank, backend=argv[3], device=argv[4])
    return argv[5:]


def _selftest_main(argv) -> None:
    import torch.distributed as dist

    shard, chrom, origin, bin_size, n_bins, out = _join(argv)
    hist = shard_bin_histogram(shard, chrom, int(origin), int(bin_size),
                               int(n_bins))
    np.save(out, hist)
    print(f"rank {dist.get_rank()}/{dist.get_world_size()}: "
          f"bins_total={int(hist.sum())}")
    dist.destroy_process_group()


def _pipeline_main(argv) -> None:
    """Full-pipeline worker, one per shard: each process writes graphs and
    cycles to ``<prefix>.p<rank>_...``, which must equal the single-process
    run's byte for byte."""
    import torch.distributed as dist

    cnv_seed, cn_seg, prefix, *shards = _join(argv)
    rank, world = dist.get_rank(), dist.get_world_size()
    if len(shards) != world:
        raise ValueError(f"{len(shards)} shards for {world} processes")
    rec = distributed_reconstruct_graphs(shards, cnv_seed, cn_seg,
                                         f"{prefix}.p{rank}")
    rec.bam.close()
    print(f"rank {rank}/{world}: graphs={len(rec.graphs)}")
    dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1:2] == ["pipeline"]:
        _pipeline_main(sys.argv[2:])
    else:
        _selftest_main(sys.argv[1:])
