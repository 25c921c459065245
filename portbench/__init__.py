"""The benchmark of ``cerebro_tpu_torch`` on one NVIDIA H100: see
``portbench/run.py`` for the command, ``PERF.md`` for the cells."""
