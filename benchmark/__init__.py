"""The benchmark of the PyTorch and CUDA port: ``python3 benchmark/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` (see
``BENCHMARK.json`` at the repository's root and ``PERF.md``)."""
