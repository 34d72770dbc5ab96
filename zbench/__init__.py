"""zbench: the benchmark of zeebe_tpu_torch's served path.

``python3 zbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once; see ``zbench/README.md``."""
