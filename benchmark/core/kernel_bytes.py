"""Bytes a kernel's launch needs, counted from its arguments: each input
byte read once, each output byte written once."""

# K1 reads three int32 columns a pair (qgap, grr, meta) and writes one
# bool a pair (``chip_smoke.bound_v3``: 12 B a pair plus the mask)
K1_IN_BYTES_PER_PAIR = 12
K1_OUT_BYTES_PER_PAIR = 1


def k1_bytes(n_pairs: int) -> int:
    return (K1_IN_BYTES_PER_PAIR + K1_OUT_BYTES_PER_PAIR) * int(n_pairs)


def k1_launch_bytes(args, kwargs, out) -> int:
    """Bytes of one ``ops.kernels.pair3_hitmask(qgap, grr, meta, ...)``
    call that launched on the card (a CPU call runs no kernel)."""
    qgap = args[0] if args else kwargs["qgap"]
    if qgap.device.type != "cuda":
        return 0
    return k1_bytes(qgap.shape[0])
