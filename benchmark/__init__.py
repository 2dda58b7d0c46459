"""The benchmark of `ddgan_torch` on an NVIDIA GPU: one cell a run,
`python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>`."""
