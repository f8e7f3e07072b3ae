"""BAM records reconstructed a second of wall time: the records of every
sample in the traced window over the window, which ends with the last
sample (outputs written and closed, the card synchronised)."""


def read(t):
    if not t.samples or t.t1 <= t.t0:
        return None
    return t.records / (t.t1 - t.t0)
