"""DDGAN in PyTorch and CUDA for the NVIDIA H100 (sm_90a).

A port of the JAX package `ddgan_tpu`, module for module, with NCHW tensors
at every API so reference-format `.pth` weights load directly. The reverse
samplers of the flagship CIFAR-10 and the CelebA-HQ 256 recipes run end to
end, and so does one-GPU training through the train CLIs (`cli.train_cli`,
`cli.main_cli`: the loop `train.train`, checkpoints in the reference's
torch format, the datasets of `data/` that need no image decoder), and so does
evaluation (`eval/`: FID-InceptionV3, FID and the Inception Score, and
`--compute_fid` in the sampler CLI, which also reads the JAX package's
`netG_*.ckpt` through `compat/msgpack.py`), and so does PSO (kind_of_optim
'pso' through the train CLIs, `train/pso_optim.py` and `train/pso_step.py`;
the hyperparameter search `pso/`), and a training run moves between the
packages (`compat/content.py`: `content.ckpt` ↔ `content.pth`). The two
kernels that the JAX package wrote in Pallas are hand-written CUDA kernels
here, behind autograd Functions: the 2x FIR resampling (`ops/fir2x.py`,
`csrc/fir2x.cu`) and the gated 3x3 conv (`ops/pair_conv.py`,
`csrc/pair_conv3x3.cu`).

Entry points run on the GPU unless the caller asks for the CPU, by a
`device="cpu"` argument or `DDGAN_TORCH_DEVICE=cpu` (see `_device.py`).
"""

from ._device import resolve_device  # noqa: F401
