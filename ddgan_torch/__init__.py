"""DDGAN in PyTorch and CUDA for the NVIDIA H100 (sm_90a).

A port of the JAX package `ddgan_tpu`, module for module, with NCHW tensors
at every API so reference-format `.pth` weights load directly. The T=4
reverse sampler of the flagship CIFAR-10 recipe runs end to end; the 2x FIR
resampling that the JAX package wrote as a Pallas kernel is a hand-written
CUDA kernel here (`ops/fir2x.py`, `csrc/fir2x.cu`).

Entry points run on the GPU unless the caller asks for the CPU, by a
`device="cpu"` argument or `DDGAN_TORCH_DEVICE=cpu` (see `_device.py`).
"""

from ._device import resolve_device  # noqa: F401
