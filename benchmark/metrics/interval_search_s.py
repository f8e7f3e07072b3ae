"""Seconds a sample in the interval search: chimeric alignments hashed to CN
segments, the amplicon intervals grown and merged, and the breakpoints of
large CIGAR deletions."""
SPANS = {"interval_search": [
    "coral_tpu_torch.reconstruct:Reconstruction.hash_to_segments",
    "coral_tpu_torch.reconstruct:Reconstruction.find_amplicon_intervals",
    "coral_tpu_torch.reconstruct:Reconstruction.find_smalldel_breakpoints"]}


def read(t):
    return t.per_sample("interval_search")
