"""The end-to-end benchmark of ``anap3_tpu_torch`` on one CUDA card.

``python3 -m ldc_bench --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON line.
See ``README.md`` beside this file.
"""
