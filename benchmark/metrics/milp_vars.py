"""Variables a sample of the decomposition's selection MILPs, summed over
every solve, from the program's counter ``milp_vars``
(``cycles.decomposition._solve_selection_milp``: two a candidate walk,
and one a path constraint where it is soft), taken over the traced
window.  Nothing where the program has no such counter."""
from program_trace import begin, counter_per_sample  # noqa: F401


def read(t):
    return counter_per_sample(t, "milp_vars")
