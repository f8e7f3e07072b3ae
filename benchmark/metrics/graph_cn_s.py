"""Seconds a sample building the breakpoint graphs, assigning their read
counts and coverage, balancing their CN and writing the graph files; the
span ends in a device synchronise (the batch CN engine runs there)."""
SPANS = {"graph_cn": [
    "coral_tpu_torch.reconstruct:Reconstruction.build_graph",
    "coral_tpu_torch.reconstruct:Reconstruction.assign_cov",
    "coral_tpu_torch.reconstruct:Reconstruction.compute_cn",
    "coral_tpu_torch.graph.breakpoint_graph:write_graph_file"]}
SYNC = ("graph_cn",)


def read(t):
    return t.per_sample("graph_cn")
