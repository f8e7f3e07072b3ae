"""The share of the region decodes' inflated payload bytes that were
inflated on more than one thread: the program's counters of bytes the
decodes inflated on a pool of threads and of all bytes they inflated,
taken over the traced window, as pooled / inflated.  Nothing where the
program has no counter of pooled bytes or the window decoded nothing."""


def begin(t):
    from coral_tpu_torch import tracing

    if hasattr(tracing, "counters"):
        c = tracing.counters()
        if "decode_pooled_bytes" in c:
            t.marks["pool_counters"] = c


def read(t):
    from coral_tpu_torch import tracing

    if "pool_counters" not in t.marks:
        return None
    c0, c1 = t.marks["pool_counters"], tracing.counters()
    decoded = c1["decode_inflated_bytes"] - c0["decode_inflated_bytes"]
    pooled = c1["decode_pooled_bytes"] - c0["decode_pooled_bytes"]
    return pooled / decoded if decoded > 0 else None
