"""Seconds a sample in the native BAM scan, from the program's own span
``bam.scan`` (``native.bamcore.scan_into``): the BGZF stream inflated once
and its records parsed into the record table.  Nothing where the program
has no such span."""


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
    secs = [r.t1 - r.t0 for r in tracing.spans_since(t.marks["span_seq"])
            if r.name == "bam.scan" and t.t0 <= r.t0 <= t.t1]
    return sum(secs) / t.samples if secs else None
