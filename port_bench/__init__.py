"""The benchmark of the PyTorch and CUDA port (`ray_tpu_torch`) on an
NVIDIA H100: one command runs one cell once (`python3 -m
port_bench.run`); see `port_bench/README.md`.  It imports neither JAX
nor the JAX package."""
