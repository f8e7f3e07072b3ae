"""The port's benchmark and stress tools, each the counterpart of a JAX
package tool of the same name (``tools/``, ``bench.py``,
``examples/quickstart.py``): the same arguments and JSON keys, the port's
engine names, and ``--device`` (``cuda`` by default; a CUDA request
without a card raises).

    python -m coral_tpu_torch.tools.bench_wgs OUT [--engine E] [--device D]

:mod:`bench_common` holds the inputs and the one CUDA-event timer that
the tools, ``chip_smoke.py`` and :mod:`kernel_ab` share.  Importing a
tool imports no CUDA code and starts nothing.
"""
