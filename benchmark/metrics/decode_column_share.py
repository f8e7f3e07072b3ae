"""The share of the region decodes' records that the scan's columns
answered without inflating them: the program's counters of records
answered from the columns and of records walked from inflated bytes, taken
over the traced window, as column / (column + walked).  Nothing where the
program has no such counters or the window decoded no record."""


def begin(t):
    from coral_tpu_torch import tracing

    if hasattr(tracing, "counters"):
        c = tracing.counters()
        if "decode_column_records" in c:
            t.marks["column_counters"] = c


def read(t):
    from coral_tpu_torch import tracing

    if "column_counters" not in t.marks:
        return None
    c0, c1 = t.marks["column_counters"], tracing.counters()
    column = c1["decode_column_records"] - c0["decode_column_records"]
    walked = c1["decode_walked_records"] - c0["decode_walked_records"]
    return column / (column + walked) if column + walked > 0 else None
