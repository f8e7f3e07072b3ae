"""The program's own spans and counters (``coral_tpu_torch.tracing``) over
a traced window, for the metric readers that read them: ``begin`` turns
the program's tracing on and marks where the window starts;
``span_seconds`` and ``counter_per_sample`` read a span's seconds and a
counter's growth over the window, a sample.  Each gives nothing where the
program has no such span or counter, or the window ran no sample."""


def begin(t):
    from coral_tpu_torch import tracing

    if hasattr(tracing, "span"):
        tracing.enable()
        t.marks["span_seq"] = tracing.last_seq()
        t.marks["counters"] = tracing.counters()


def span_seconds(t, name):
    """Seconds a sample of the spans ``name`` that started in the window."""
    from coral_tpu_torch import tracing

    if "span_seq" not in t.marks or not t.samples:
        return None
    tracing.disable()
    secs = [r.t1 - r.t0 for r in tracing.spans_since(t.marks["span_seq"])
            if r.name == name and t.t0 <= r.t0 <= t.t1]
    return sum(secs) / t.samples if secs else None


def counter_per_sample(t, name):
    """The counter ``name``'s growth over the window, a sample."""
    from coral_tpu_torch import tracing

    c0 = t.marks.get("counters", {})
    if name not in c0 or not t.samples:
        return None
    tracing.disable()
    return (tracing.counters()[name] - c0[name]) / t.samples
