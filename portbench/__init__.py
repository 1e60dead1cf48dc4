"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one run of
one cell with ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``; see ``BENCHMARK.json`` at the root."""
