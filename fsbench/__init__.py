"""fsbench: the benchmark of t3fs_torch, the PyTorch and CUDA port.

`python3 -m fsbench.run` runs one cell of BENCHMARK.json on the card; see
fsbench/run.py.  Nothing here imports jax or the JAX package."""
