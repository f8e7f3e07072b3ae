"""How many times a sample inflates each byte of the BAM's payload: the
program's counters of bytes inflated by the scan and by the region
decodes, taken over the traced window, as (scan + decode) / scan; 1.0 is
one inflate of every byte.  Nothing where the program has no counters or
the window scanned nothing."""


def begin(t):
    from coral_tpu_torch import tracing

    if hasattr(tracing, "span"):
        tracing.enable()
        t.marks["span_seq"] = tracing.last_seq()
        t.marks["counters"] = tracing.counters()


def read(t):
    from coral_tpu_torch import tracing

    if "counters" not in t.marks:
        return None
    tracing.disable()
    c0, c1 = t.marks["counters"], tracing.counters()
    scan = c1["scan_inflated_bytes"] - c0["scan_inflated_bytes"]
    decode = c1["decode_inflated_bytes"] - c0["decode_inflated_bytes"]
    return (scan + decode) / scan if scan > 0 else None
