"""What a sample's reconstruct leaves behind, gathered for the comparison."""
from __future__ import annotations

import os
from typing import List


def gather(prefix: str, cn: List[dict], with_cycles: bool) -> List[dict]:
    """Each amplicon's graph file and cycles file under ``prefix``, with the
    CN of its edges at full precision as the program's graphs held them
    after the call (``cn``: one dict an amplicon, lists by edge kind)."""
    out = []
    for gi, cn_g in enumerate(cn):
        base = f"{prefix}_amplicon{gi + 1}"
        item = {"cn": cn_g, "graph": _read(base + "_graph.txt")}
        if with_cycles:
            item["cycles"] = _read(base + "_cycles.txt")
        out.append(item)
    return out


def _read(path: str):
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        return fh.read()
