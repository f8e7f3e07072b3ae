"""Seconds a sample in breakpoint search: the pairs packed and scored on the
card (K1), the hits turned into breakpoints, clustered and called; the span
ends in a device synchronise."""
SPANS = {"breakpoints": [
    "coral_tpu_torch.reconstruct:Reconstruction.find_breakpoints"]}
SYNC = ("breakpoints",)


def read(t):
    return t.per_sample("breakpoints")
