"""Seconds a sample that no stage of the program covers: the traced
window less the union of the program's six stage spans (``scan_collect``,
``interval_search``, ``breakpoints``, ``graph_cn``, ``cycles``,
``path_constraints``; ``reconstruct.py``).  Nothing where the program has
no such spans."""
STAGES = ("scan_collect", "interval_search", "breakpoints", "graph_cn",
          "cycles", "path_constraints")


def begin(t):
    from coral_tpu_torch import tracing

    if hasattr(tracing, "span"):
        tracing.enable()
        t.marks["span_seq"] = tracing.last_seq()
        t.marks["counters"] = tracing.counters()


def read(t):
    from coral_tpu_torch import tracing

    if "span_seq" not in t.marks or not t.samples:
        return None
    tracing.disable()
    iv = sorted((r.t0, min(r.t1, t.t1))
                for r in tracing.spans_since(t.marks["span_seq"])
                if r.name in STAGES and t.t0 <= r.t0 <= t.t1)
    if not iv:
        return None
    covered, end = 0.0, t.t0
    for s, e in iv:
        if e > end:
            covered += e - max(s, end)
            end = e
    return (t.t1 - t.t0 - covered) / t.samples
