"""FID InceptionV3 in PyTorch (NCHW).

The counterpart of `ddgan_tpu/eval/inception.py`: the TF-FID Inception
variant (pytorch_fid's `fid_inception_v3`, torchvision's InceptionV3 with
the FID pooling patches). In blocks A, C and E_1 the pool branch averages
with `count_include_pad=False`, and Mixed_7c (E_2) keeps a stride-1 max
pool, the TF-FID checkpoint's quirk. Submodules carry the names of the
torch checkpoint (`Conv2d_1a_3x3.conv.weight`,
`Mixed_5b.branch1x1.bn.running_mean`, `fc.weight`, ...), so the
`pt_inception-2015-12-05-6726825d.pth` state_dict loads with
`load_state_dict(strict=True)` once `params_from_torch_state_dict` has
dropped its aux head and BatchNorm counters. That file is read from a local
path only (`$DDGAN_TPU_INCEPTION_PATH`, the JAX package's variable, so one
environment drives both packages). Without it,
`DDGAN_TPU_INCEPTION_RANDOM=<seed>` selects seeded random weights, drawn
exactly as the JAX package draws them.

Input protocol: NCHW float in [0, 1]; a bilinear resize to 299 x 299 as
`jax.image.resize` does it (half-pixel centres, antialiased when it
shrinks); then x * 2 - 1. Convolutions run in float32; `default_feature_fn`
and `default_logits_fn` turn TF32 off while they run.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .._device import resolve_device

# dims -> block index, as in pytorch_fid (FID uses 2048 by default)
BLOCK_INDEX_BY_DIM = {64: 0, 192: 1, 768: 2, 2048: 3}

DEFAULT_WEIGHTS_ENV = "DDGAN_TPU_INCEPTION_PATH"
RANDOM_WEIGHTS_ENV = "DDGAN_TPU_INCEPTION_RANDOM"
NUM_CLASSES = 1008  # the TF-FID checkpoint's classifier width


class BatchNormEval(nn.Module):
    """BatchNorm in its eval form, eps 1e-3 (torchvision's BasicConv2d), with
    the four tensors of the checkpoint and no `num_batches_tracked`."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=self.eps)


class BasicConv2d(nn.Module):
    """A bias-free conv, BatchNorm (eval, eps 1e-3), ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = BatchNormEval(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_no_pad(x: torch.Tensor) -> torch.Tensor:
    """The FID patch: a 3x3 stride-1 mean that does not count the padding."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_no_pad(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(768, 192, 1)
        self.branch7x7_1 = BasicConv2d(768, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(768, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(768, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                      self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(_avg_pool_no_pad(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for layer in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = layer(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    """E_1 (`pool="avg_nopad"`, Mixed_7b) or E_2 (`pool="max"`, Mixed_7c,
    which keeps the stride-1 max pool, pad 1)."""

    def __init__(self, cin: int, pool: str):
        super().__init__()
        if pool not in ("avg_nopad", "max"):
            raise ValueError(f"unknown pool mode {pool!r}")
        self.pool = pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool == "avg_nopad":
            bp = _avg_pool_no_pad(x)
        else:
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


def resize_bilinear_299(x: torch.Tensor) -> torch.Tensor:
    """`jax.image.resize(x, (..., 299, 299, ...), "bilinear")` in NCHW: the
    triangle kernel at half-pixel centres, widened by the scale when it
    shrinks (antialiased), weights renormalised at the borders."""
    return F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                         antialias=True)


class InceptionV3FID(nn.Module):
    """Feature extractor over the four FID blocks (64/192/768/2048 dims);
    with `num_classes`, also the classifier head `fc` (Inception Score)."""

    def __init__(self, output_blocks: Sequence[int] = (3,), resize_input: bool = True,
                 normalize_input: bool = True, num_classes: int = 0):
        super().__init__()
        self.output_blocks = tuple(sorted(output_blocks))
        self.last_needed_block = max(self.output_blocks)
        self.resize_input = resize_input
        self.normalize_input = normalize_input
        if num_classes and self.last_needed_block != 3:
            raise ValueError("the classifier head reads block 3 (pool3)")
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        if self.last_needed_block >= 1:
            self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
            self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        if self.last_needed_block >= 2:
            self.Mixed_5b = InceptionA(192, 32)
            self.Mixed_5c = InceptionA(256, 64)
            self.Mixed_5d = InceptionA(288, 64)
            self.Mixed_6a = InceptionB(288)
            self.Mixed_6b = InceptionC(128)
            self.Mixed_6c = InceptionC(160)
            self.Mixed_6d = InceptionC(160)
            self.Mixed_6e = InceptionC(192)
        if self.last_needed_block >= 3:
            self.Mixed_7a = InceptionD(768)
            self.Mixed_7b = InceptionE(1280, "avg_nopad")
            self.Mixed_7c = InceptionE(2048, "max")
        self.fc = nn.Linear(2048, num_classes) if num_classes else None
        self.requires_grad_(False)
        self.eval()

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x: NCHW float in [0, 1] -> the requested blocks' NCHW feature maps."""
        outputs = []
        if self.resize_input:
            x = resize_bilinear_299(x)
        if self.normalize_input:
            x = 2 * x - 1
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        if 0 in self.output_blocks:
            outputs.append(x)
        if self.last_needed_block >= 1:
            x = F.max_pool2d(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)), 3, stride=2)
            if 1 in self.output_blocks:
                outputs.append(x)
        if self.last_needed_block >= 2:
            for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b",
                         "Mixed_6c", "Mixed_6d", "Mixed_6e"):
                x = getattr(self, name)(x)
            if 2 in self.output_blocks:
                outputs.append(x)
        if self.last_needed_block >= 3:
            x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
            x = x.mean(dim=(2, 3), keepdim=True)  # adaptive average pool to 1x1
            if 3 in self.output_blocks:
                outputs.append(x)
        return outputs

    def pool_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, dims) features of the highest requested block."""
        out = self(x)[-1]
        return out.mean(dim=(2, 3)) if out.shape[2] > 1 else out[:, :, 0, 0]

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """(B, num_classes) classifier logits from the pool3 features."""
        if self.fc is None:
            raise ValueError("built without a classifier head (num_classes=0)")
        return self.fc(self.pool_features(x))


# --------------------------------------------------------------------------
# weights
def params_from_torch_state_dict(sd, keep_fc: bool = False) -> dict[str, torch.Tensor]:
    """The state_dict of `InceptionV3FID` from a fid_inception_v3-shaped one:
    AuxLogits and BatchNorm counters are always dropped, fc.* kept only with
    `keep_fc` (the Inception Score head). Values become f32 CPU tensors."""
    out = {}
    for k, v in sd.items():
        if k.startswith("AuxLogits.") or k.endswith("num_batches_tracked"):
            continue
        if k.startswith("fc.") and not keep_fc:
            continue
        v = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        out[k] = v.detach().to("cpu", torch.float32)
    return out


def _weights_file(path: str | None) -> str:
    path = path or os.environ.get(DEFAULT_WEIGHTS_ENV)
    if not path or not os.path.exists(path):
        raise FileNotFoundError(
            "FID Inception weights not found. Download "
            "pt_inception-2015-12-05-6726825d.pth (pytorch_fid's inception.py:22) "
            f"and point {DEFAULT_WEIGHTS_ENV} at it (no download here)."
        )
    return path


def load_fid_inception_params(path: str | None = None) -> dict[str, torch.Tensor]:
    """The pt_inception-2015-12-05 torch weights without the classifier head
    (FID reads pool3), for `InceptionV3FID()`."""
    sd = torch.load(_weights_file(path), map_location="cpu", weights_only=True)
    return params_from_torch_state_dict(sd, keep_fc=False)


def load_fid_inception_logits_params(path: str | None = None) -> dict[str, torch.Tensor]:
    """Like `load_fid_inception_params`, keeping the 1008-way fc head used
    for the Inception Score."""
    sd = torch.load(_weights_file(path), map_location="cpu", weights_only=True)
    return params_from_torch_state_dict(sd, keep_fc=True)


def random_fid_inception_params(seed: int = 0) -> dict[str, torch.Tensor]:
    """Correctly shaped random weights, equal to the JAX package's
    `random_fid_inception_params(seed)` transposed to OIHW.

    The same `np.random.RandomState(seed)` draws each conv He-scaled (std
    sqrt(2 / fan_in)) in HWIO shape `(kh, kw, cin, cout)`, in the order the
    network registers its convs, which is the JAX package's draw order;
    drawing OIHW directly would give other weights with the same
    statistics. BatchNorm is the identity (0, 1 running stats).
    """
    rng = np.random.RandomState(seed)
    params: dict[str, torch.Tensor] = {}
    with torch.device("meta"):  # shapes only
        net = InceptionV3FID()
    for name, m in net.named_modules():
        if not isinstance(m, BasicConv2d):
            continue
        cout, cin, kh, kw = m.conv.weight.shape
        # a float64 product (np.sqrt gives a float64 scalar), rounded to
        # float32 where the JAX package's network takes it in
        hwio = rng.randn(kh, kw, cin, cout).astype(np.float32) * np.sqrt(2.0 / (cin * kh * kw))
        params[name + ".conv.weight"] = torch.from_numpy(
            np.ascontiguousarray(hwio.transpose(3, 2, 0, 1), dtype=np.float32))
        params[name + ".bn.weight"] = torch.ones(cout)
        params[name + ".bn.bias"] = torch.zeros(cout)
        params[name + ".bn.running_mean"] = torch.zeros(cout)
        params[name + ".bn.running_var"] = torch.ones(cout)
    return params


def random_fid_inception_logits_params(seed: int = 0) -> dict[str, torch.Tensor]:
    """`random_fid_inception_params(seed)` and a random 1008-way fc head from
    `RandomState(seed + 1)`, as the JAX package draws them."""
    params = random_fid_inception_params(seed)
    rng = np.random.RandomState(seed + 1)
    params["fc.weight"] = torch.from_numpy(
        (rng.randn(NUM_CLASSES, 2048).astype(np.float32) * np.sqrt(1.0 / 2048)).astype(np.float32))
    params["fc.bias"] = torch.zeros(NUM_CLASSES)
    return params


def _pick_weights(weights_path: str | None, random_note: str, random_fn, load_fn):
    """The weights `default_feature_fn` / `default_logits_fn` use: real ones
    from a path, else seeded random ones when $DDGAN_TPU_INCEPTION_RANDOM is
    set, saying loudly which (the JAX package's messages)."""
    rand_seed = os.environ.get(RANDOM_WEIGHTS_ENV)
    real = weights_path or os.environ.get(DEFAULT_WEIGHTS_ENV)
    if rand_seed is not None and real:
        # the real weights win; say so, so that no score is mislabelled
        print(
            f"NOTE: both {RANDOM_WEIGHTS_ENV} and a weights path are set; "
            f"using REAL weights from {real} and ignoring {RANDOM_WEIGHTS_ENV}={rand_seed}."
        )
    if rand_seed is not None and not real:
        print(random_note.format(f"{RANDOM_WEIGHTS_ENV}={rand_seed}"))
        return random_fn(int(rand_seed))
    return load_fn(weights_path)


@contextlib.contextmanager
def float32_exact():
    """TF32 off for cuDNN convolutions and matmuls while the block runs
    (cuDNN's flag defaults to on); the caller's settings come back after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _batch_fn(model: InceptionV3FID, head: Callable, device: torch.device):
    model = model.to(device)

    @torch.no_grad()
    def fn(batch: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(batch, dtype=np.float32))
        x = x.to(device).permute(0, 3, 1, 2)
        with float32_exact():
            return head(x).cpu().numpy()

    return fn


def default_feature_fn(dims: int = 2048, weights_path: str | None = None,
                       device=None) -> Callable[[np.ndarray], np.ndarray]:
    """(B, H, W, C) float in [0, 1] -> (B, dims) features, as numpy, for FID;
    computed on `resolve_device(device)` in float32 with TF32 off.

    Real weights come from `weights_path` or $DDGAN_TPU_INCEPTION_PATH;
    without them, DDGAN_TPU_INCEPTION_RANDOM=<seed> selects seeded random
    weights, a fixed random feature space whose "FID" is self-consistent
    between runs but not comparable to published numbers (a loud warning is
    printed).
    """
    block = BLOCK_INDEX_BY_DIM[dims]
    dev = resolve_device(device)
    params = _pick_weights(
        weights_path, "WARNING: using RANDOM Inception weights ({}); scores are random-feature "
        "Fréchet distances, not comparable to published FID.",
        random_fid_inception_params, load_fid_inception_params)
    model = InceptionV3FID(output_blocks=(block,))
    model.load_state_dict({k: v for k, v in params.items() if k in model.state_dict()},
                          strict=True)
    return _batch_fn(model, model.pool_features, dev)


def default_logits_fn(weights_path: str | None = None,
                      device=None) -> Callable[[np.ndarray], np.ndarray]:
    """(B, H, W, C) float in [0, 1] -> (B, 1008) logits, as numpy, for the
    Inception Score; the same weight sources and device rule as
    `default_feature_fn`."""
    dev = resolve_device(device)
    params = _pick_weights(
        weights_path, "WARNING: using RANDOM Inception classifier ({}); Inception Scores are "
        "in a random-logit space, not comparable to published IS.",
        random_fid_inception_logits_params, load_fid_inception_logits_params)
    model = InceptionV3FID(output_blocks=(3,), num_classes=NUM_CLASSES)
    model.load_state_dict(params, strict=True)
    return _batch_fn(model, model.logits, dev)
