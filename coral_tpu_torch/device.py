"""Device selection for the port: explicit, and never a silent fallback."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``"cuda"``, ``"cuda:N"``, ``"cpu"`` (or a ``torch.device``) ->
    ``torch.device``.

    Raises when CUDA is asked for and no card (or not that card) is
    present: a CUDA request is never moved to the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() "
            "is False")
    if dev.index is not None and dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"device {device!r} requested but only "
            f"{torch.cuda.device_count()} CUDA device(s) are present")
    return dev
