"""The benchmark of libavif_tpu_torch, the PyTorch and CUDA port.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on one CUDA
device and prints its result as the last line of standard output.
"""
