"""Seconds a sample enumerating the decomposition's candidate walks, from
the program's own span ``cycles.enumerate`` (``cycles.decomposition.
cycle_decomposition`` around each ``enumerate_candidates`` call, inside the
``cycles`` stage).  Nothing where the program has no such span."""
from program_trace import begin, span_seconds  # noqa: F401


def read(t):
    return span_seconds(t, "cycles.enumerate")
