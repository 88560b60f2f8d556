"""streambench: the benchmark of flink_tpu_torch, the PyTorch and CUDA port.
Run one cell as `python streambench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>` from the root of a checkout."""
