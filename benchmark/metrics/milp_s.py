"""Seconds a sample in HiGHS solving the decomposition's selection MILPs
(``scipy.optimize.milp``), from the program's own span ``cycles.solve``
(``cycles.decomposition._solve_selection_milp``: every joint and
postprocess solve).  Nothing where the program has no such span or the
window solved none."""
from program_trace import begin, span_seconds  # noqa: F401


def read(t):
    return span_seconds(t, "cycles.solve")
