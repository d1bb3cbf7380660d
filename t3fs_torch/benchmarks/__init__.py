"""The port's benches: twins of benchmarks/devbench.py and of the decode
microbench of benchmarks/ec_recovery_bench.py.  The headline bench is
t3fs_torch/bench.py."""
