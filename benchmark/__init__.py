"""The benchmark of ``rnntransducer_tpu_torch`` on one NVIDIA H100: the
harness (``run.py``), its drivers, per-layer metric readers, roofline
counts, configurations, traffic mixes and the plain reference that decides
``correct``.  See ``PERF.md`` at the root of the repository."""
