"""Seconds a sample in the native region decodes, from the program's own
spans ``decode.coverage_sum``, ``decode.coverage_profile`` and
``decode.del_gaps`` (``io.bam.BamFile``): each inflates its region's BGZF
blocks again and walks the records' CIGARs.  Nothing where the program has
no such spans."""


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
    recs = [r for r in tracing.spans_since(t.marks["span_seq"])
            if t.t0 <= r.t0 <= t.t1]
    if not recs:
        return None
    return sum(r.t1 - r.t0 for r in recs
               if r.name.startswith("decode.")) / t.samples
