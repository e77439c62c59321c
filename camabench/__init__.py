"""camabench: the benchmark of cama_tpu_torch, the PyTorch and CUDA port of
CAMA's overlay videos and map evaluation, on one CUDA card.

One cell of BENCHMARK.json a run: `python3 camabench/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>` (run.py).  The harness
imports nothing of the JAX package; the reference (reference/) imports
nothing of the port.
"""
