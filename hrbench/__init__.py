"""The benchmark of the PyTorch + CUDA port (hopperrender_tpu_torch): one
cell a run, `python3 -m hrbench.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`, as BENCHMARK.json at the checkout's root describes it.
It imports neither JAX nor the JAX package; its reference imports nothing
of the program."""
