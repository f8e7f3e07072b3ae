"""Seconds a sample of pair scoring, from the program's own counter:
``ops.pairs.RouteRecord.seconds`` (host clock around packing, the copy to
the card, the kernel and the copy back), summed over the records that the
window's samples appended."""


def begin(t):
    from coral_tpu_torch.ops import pairs

    t.marks["route_seq"] = pairs.last_route_seq()


def read(t):
    from coral_tpu_torch.ops import pairs

    recs = pairs.route_records_since(t.marks["route_seq"])
    if not recs or not t.samples:
        return None
    return sum(r.seconds for r in recs) / t.samples
