"""Seconds a sample in cycle decomposition: ``reconstruct.reconstruct_cycles``
(path constraints, the decomposition, the cycles files)."""
SPANS = {"cycles": ["coral_tpu_torch.reconstruct:reconstruct_cycles"]}


def read(t):
    return t.per_sample("cycles")
