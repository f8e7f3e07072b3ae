"""Wall-clock trace logging, spans and decode counters.

Log lines: the reference prefixes every log line with ``#TIME
<seconds-since-start>`` by hand at each call site (``global_names.TSTART``;
pattern throughout ``src/infer_breakpoint_graph.py`` etc.).  Here a
logging.Formatter injects the same prefix automatically so modules just
use plain ``logging``.

Spans: ``with span(name):`` around a stage or a work site records
``(name, t0, t1)`` on ``time.perf_counter()`` and opens the profiler range
``span:<name>``, so that a device trace names what the host was doing.
Tracing is off until :func:`enable`; off, ``span`` checks one flag and
returns a shared no-op, reading no clock and calling nothing of ``torch``.
The records sit in a bounded list whose head is trimmed; each carries a
sequence number, read with :func:`last_seq` and :func:`spans_since`.

Counters: :func:`counters` snapshots the native BAM core's process-wide
counts of BGZF payload bytes inflated (``scan_inflated_bytes``,
``decode_inflated_bytes``), of region-decode records answered from the
scan's columns or walked (``decode_column_records``,
``decode_walked_records``) and the program's own counts, added under the
lock by :func:`count`; all count whether tracing is on or not.  The
program's own (``COUNTERS``): the rows ``BamFile.del_gap_alignments``
returned (``del_gap_alignments``); of each amplicon the decomposition
takes, its first pool of walks (``walk_candidates``) and its maximal path
constraints (``path_constraints_max``); the selection MILPs solved
(``milp_solves``) with their variables (``milp_vars``) and constraint rows
(``milp_rows``).
"""
from __future__ import annotations

import logging
import threading
import time
from typing import List, NamedTuple

_TSTART = time.time()


def reset_epoch() -> None:
    global _TSTART
    _TSTART = time.time()


def elapsed() -> float:
    return time.time() - _TSTART


class TimeTagFormatter(logging.Formatter):
    """``[name:LEVEL]\\t#TIME <t>\\t<message>`` — reference log line shape."""

    def format(self, record: logging.LogRecord) -> str:
        base = super().format(record)
        return f"[{record.name}:{record.levelname}]\t#TIME {elapsed():.4f}\t{base}"


def setup_file_logging(log_fn: str, level: int = logging.DEBUG) -> None:
    reset_epoch()
    handler = logging.FileHandler(log_fn, mode="w")
    handler.setFormatter(TimeTagFormatter("%(message)s"))
    # scope to the engine's loggers so third-party DEBUG noise (jax etc.)
    # stays out of the trace file
    pkg = logging.getLogger("coral_tpu_torch")
    pkg.setLevel(level)
    pkg.addHandler(handler)
    pkg.propagate = False


class SpanRecord(NamedTuple):
    """One closed span: its name, start and end on ``time.perf_counter()``
    and its sequence number (increasing across the process)."""
    name: str
    t0: float
    t1: float
    seq: int


MAX_SPANS = 1 << 16
SPANS: List[SpanRecord] = []
_enabled = False
_seq = 0
_lock = threading.Lock()


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def last_seq() -> int:
    """Records with ``seq`` greater than this were closed after the call."""
    return _seq


def spans_since(seq: int) -> List[SpanRecord]:
    return [r for r in SPANS if r.seq > seq]


def _record(name: str, t0: float, t1: float) -> None:
    global _seq
    with _lock:
        _seq += 1
        SPANS.append(SpanRecord(name, t0, t1, _seq))
        if len(SPANS) > MAX_SPANS:
            del SPANS[:MAX_SPANS // 2]


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "sync", "t0", "_range")

    def __init__(self, name: str, sync: bool):
        self.name, self.sync = name, sync

    def __enter__(self):
        import torch

        self.t0 = time.perf_counter()
        self._range = torch.profiler.record_function("span:" + self.name)
        self._range.__enter__()
        return None

    def __exit__(self, *exc):
        import torch

        try:
            if self.sync and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            _record(self.name, self.t0, time.perf_counter())
        finally:
            self._range.__exit__(*exc)
        return False


def span(name: str, sync: bool = False):
    """A context manager that records the span ``name`` while tracing is
    on; ``sync=True`` closes it with ``torch.cuda.synchronize()`` when a
    CUDA context exists, so device work queued inside counts."""
    if not _enabled:
        return _NO_SPAN
    return _Span(name, sync)


COUNTERS = ("del_gap_alignments", "walk_candidates", "path_constraints_max",
            "milp_solves", "milp_vars", "milp_rows")
_counts = dict.fromkeys(COUNTERS, 0)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the program's counter ``name``, tracing on or off."""
    with _lock:
        _counts[name] += n


def counters() -> dict:
    """The native BAM core's counters and the program's own now, as ints;
    raises OSError where the library cannot be built."""
    from .native import bamcore

    out = bamcore.counters()
    with _lock:
        out.update(_counts)
    return out
