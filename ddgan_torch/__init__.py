"""DDGAN in PyTorch and CUDA for the NVIDIA H100 (sm_90a).

A port of the JAX package `ddgan_tpu`, module for module, with NCHW tensors
at every API so reference-format `.pth` weights load directly. The reverse
samplers of the flagship CIFAR-10 and the CelebA-HQ 256 recipes run end to
end, and so does one-GPU training (`train.make_train_step`). The two
kernels that the JAX package wrote in Pallas are hand-written CUDA kernels
here, behind autograd Functions: the 2x FIR resampling (`ops/fir2x.py`,
`csrc/fir2x.cu`) and the gated 3x3 conv (`ops/pair_conv.py`,
`csrc/pair_conv3x3.cu`).

Entry points run on the GPU unless the caller asks for the CPU, by a
`device="cpu"` argument or `DDGAN_TORCH_DEVICE=cpu` (see `_device.py`).
"""

from ._device import resolve_device  # noqa: F401
