"""K1 (``csrc/pair3.cu`` ``pair3_hitmask_kernel``) against its bytes bound:
the bytes the window's launches need (``core.kernel_bytes.k1_bytes``: 12 B
a pair read, the mask written) over the card's published bandwidth, divided
by K1's summed device time in the profiler's trace."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "core"))
from kernel_bytes import k1_launch_bytes  # noqa: E402
from peaks import H100_HBM_BYTES_PER_S  # noqa: E402

KERNEL = "pair3_hitmask"
COUNTERS = {"k1_bytes": ("coral_tpu_torch.ops.kernels:pair3_hitmask",
                         k1_launch_bytes)}


def read(t):
    d = t.device
    if d is None:
        return None
    secs = d.op_seconds(KERNEL)
    moved = t.counts.get("k1_bytes", 0.0)
    if secs <= 0 or moved <= 0:
        return None
    return 100.0 * moved / H100_HBM_BYTES_PER_S / secs
