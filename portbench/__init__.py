"""The benchmark of the PyTorch/CUDA port (``deeprank_gnn_tpu_torch``) on the
H100: ``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout runs one cell of
``BENCHMARK.json`` once. It imports nothing of JAX or of the JAX package."""
