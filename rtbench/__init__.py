"""The benchmark of ``raytracing_course_2024_tpu_torch`` on an NVIDIA GPU.

``python3 -m rtbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line. Everything that belongs to one configuration, traffic mix or
per-layer metric sits in a file of its own (``configs/``, ``workloads/``,
``metrics/``, ``scenes/``), found by the name ``BENCHMARK.json`` gives it.
The plain reference that decides ``correct`` (``reference/``) imports
neither JAX nor the program.
"""
