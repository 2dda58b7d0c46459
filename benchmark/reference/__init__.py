"""The plain reference of the benchmark: DDGAN's networks, train step and
sampler in plain PyTorch, float32, with no kernel, cache or batching.

It imports nothing of the program (`ddgan_torch`) and nothing of JAX; the
benchmark's check runs it once a run's window has closed, on the inputs,
weights and draws that the benchmark made from the seed, and compares what
the program produced with what it gives.
"""
