"""Convert AA-format cycles files to bed.

Behavioral port of the reference converter (``src/cycle2bed.py:7-77``):
colinear consecutive segments are merged, cyclic wrap-around is merged, and
``rotate_to_min`` rotates a cyclic path to start at its canonically smallest
segment on the positive strand.

Reference bugs handled deliberately:
* ``neg_plus_minus`` is a dict upstream but called as a function
  (``src/cycle2bed.py:57,63``) which crashes on the reverse-strand rotation
  path; here the strand flip is implemented correctly (the intent).
* the non-cyclic reversal test compares a value with itself
  (``cycle[-1][1] < cycle[-1][1]``, ref ``:59``), so reversal of linear paths
  effectively only triggers on a strictly smaller chromosome; we match that
  live behavior.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .constants import CHR_IDX, FLIP_STRAND


def _parse_cycles_file(cycle_fn: str):
    """Parse Segment and Cycle rows from an AA-format cycles file."""
    all_segs: Dict[str, list] = {}
    cycles: Dict[int, list] = {}
    with open(cycle_fn) as fp:
        for line in fp:
            t = line.strip().split()
            if not t:
                continue
            if t[0] == "Segment":
                all_segs[t[1]] = [t[2], int(t[3]), int(t[4])]
            elif t[0][:5] == "Cycle":
                attrs = dict(
                    kv.split("=", 1) for kv in t[0].split(";") if "=" in kv
                )
                cycle_id = int(attrs.get("Cycle", 1))
                weight = float(attrs.get("Copy_count", 1.0))
                seg_tokens = attrs.get("Segments", "0+,0-").split(",")
                cycles[cycle_id] = (seg_tokens, weight, all_segs.copy())
    return cycles


def _merge_segments(seg_tokens: List[str], all_segs: Dict[str, list]):
    """Expand segment tokens and merge colinear neighbors (ref :30-48)."""
    is_cyclic = seg_tokens[0] != "0+" or seg_tokens[-1] != "0-"
    out: List[list] = []
    for tok in seg_tokens:
        idx, strand = tok[:-1], tok[-1]
        if int(idx) <= 0:
            continue
        seg = all_segs[idx]
        if out:
            prev = out[-1]
            if (strand == "+" and prev[3] == "+" and prev[0] == seg[0]
                    and prev[2] + 1 == seg[1]):
                prev[2] = seg[2]
                continue
            if (strand == "-" and prev[3] == "-" and prev[0] == seg[0]
                    and prev[1] - 1 == seg[2]):
                prev[1] = seg[1]
                continue
        out.append([seg[0], seg[1], seg[2], strand])
    # wrap-around merges (ref :43-48)
    if len(out) > 1:
        # TWO sequential ifs, like the reference (:43-48): when the '+'
        # merge fires, the '-' test re-reads the NEW last element
        last, first = out[-1], out[0]
        if (last[3] == "+" and first[3] == "+" and last[0] == first[0]
                and last[2] + 1 == first[1]):
            first[1] = last[1]
            del out[-1]
        last = out[-1]
        if (last is not first and last[3] == "-" and first[3] == "+"
                and last[0] == first[0] and last[1] - 1 == first[2]):
            first[2] = last[2]
            del out[-1]
    return is_cyclic, out


def _rotate_to_min(cycle: List[list], is_cyclic: bool) -> List[list]:
    """Rotate/reverse to canonical orientation (ref :49-63)."""
    if len(cycle) <= 1:
        return cycle
    if is_cyclic:
        argmin = cycle.index(min(cycle, key=lambda s: (CHR_IDX[s[0]], s[1])))
        if cycle[argmin][3] == "+":
            return cycle[argmin:] + cycle[:argmin]
        rotated = cycle[: argmin + 1][::-1] + cycle[argmin + 1:][::-1]
        for seg in rotated:
            seg[3] = FLIP_STRAND[seg[3]]
        return rotated
    # Linear path: reverse only on strictly smaller chromosome (matching the
    # reference's live behavior; see module docstring).
    if CHR_IDX[cycle[-1][0]] < CHR_IDX[cycle[0][0]]:
        cycle = cycle[::-1]
        if cycle[0][3] == "-":
            for seg in cycle:
                seg[3] = FLIP_STRAND[seg[3]]
    return cycle


def convert_cycles_to_bed(
    cycle_fn: str,
    output_fn: str,
    rotate_to_min: bool = False,
    num_cycles: Optional[int] = None,
) -> None:
    """AA cycles.txt -> bed (reference ``convert_cycles_to_bed``)."""
    parsed = _parse_cycles_file(cycle_fn)
    converted: Dict[int, tuple] = {}
    for cid, (seg_tokens, weight, segs) in parsed.items():
        is_cyclic, cycle = _merge_segments(seg_tokens, segs)
        if rotate_to_min:
            cycle = _rotate_to_min(cycle, is_cyclic)
        converted[cid] = (is_cyclic, weight, cycle)

    print("Creating bed-converted cycles file: " + output_fn)
    with open(output_fn, "w") as fp:
        fp.write("#chr\tstart\tend\torientation\tcycle_id\tiscyclic\tweight\n")
        n = len(converted)
        if num_cycles:
            n = min(n, num_cycles)
        for i in range(1, n + 1):
            is_cyclic, weight, cycle = converted[i]
            for seg in cycle:
                fp.write(
                    "%s\t%d\t%d\t%s\t%d\t%s\t%f\n"
                    % (seg[0], seg[1], seg[2], seg[3], i, is_cyclic, weight)
                )
