"""Seconds a sample in the small-deletion search, from the program's own
span ``smalldel`` (``reconstruct.Reconstruction.find_smalldel_breakpoints``,
inside the ``interval_search`` stage): the ``del_gaps`` region decode over
each amplicon interval, the reads' CIGAR deletion gaps and their
clustering into breakpoints.  Nothing where the program has no such
span."""
from program_trace import begin, span_seconds  # noqa: F401


def read(t):
    return span_seconds(t, "smalldel")
