"""Seconds a sample computing path constraints from the reads that cross
breakpoints (``Reconstruction.compute_path_constraints``), part of the
cycles stage."""
SPANS = {"path_constraints": [
    "coral_tpu_torch.reconstruct:Reconstruction.compute_path_constraints"]}


def read(t):
    return t.per_sample("path_constraints")
