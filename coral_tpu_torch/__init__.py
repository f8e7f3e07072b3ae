"""coral_tpu_torch: the PyTorch + CUDA port of coral_tpu for one NVIDIA H100.

The port runs the ``reconstruct`` main path (BAM -> breakpoint graphs ->
CN balance -> cycles) with the junction-predicate kernels written by hand
in CUDA C++ for ``sm_90a`` (``csrc/pair3.cu``).  It never imports JAX:
the host-side modules of :mod:`coral_tpu` that are JAX-free (BAM scan,
chimera decode, packers, breakpoint clustering, graph build, cycle
decomposition) are imported from there as they are, and only the modules
that pull JAX in (``ops.pairs``, ``graph.cn_solver``, ``reconstruct``)
are re-homed here.  :mod:`coral_tpu` stays the reference every slice of
the port is tested against.

Every public function that creates tensors takes ``device=`` explicitly
(:func:`coral_tpu_torch.device.resolve_device`); a CUDA request without a
card raises, it never runs on the CPU instead.
"""
__version__ = "0.1.0"
