"""Config schema: the 86-key surface of the reference JSON config.

A copy of `ddgan_tpu/config.py` (the port imports nothing of the JAX
package). Reference: additionals/create_conf_default.py:17-101 (defaults),
additionals/utilities.py:123-162 (JSON load/save, with the read-update-write
semantics the train CLIs rely on).

The perf key `s2d_conv` is accepted and has no effect; `use_remat` and
`remat_policy` checkpoint the generator's resblocks (`models/ncsnpp.py`,
"auto" off in the port); `r1_shared` selects the train step's R1 formulation, and
`optimizer_sharding` "zero1" shards the Adam moments over the ranks
(`train/zero1.py`).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, List


@dataclasses.dataclass
class Config:
    """Flat config mirroring the reference schema (create_conf_default.py:17-101)."""

    # run control
    seed: int = 1024
    kind_of_optim: str = "adam"  # 'adam' or 'pso'
    use_config_file: bool = True
    config_file: str = "configs/config.json"
    mode: str = "train"
    exp: str = "exp1"
    resume: bool = False
    num_workers: int = 0
    limited_iter: Any = "no"  # 'no' or int
    # data
    dataset: str = "luna16"
    data_dir: str = "./data/Ones"
    mask_dir: str = "./data/Masks/processed_masks"
    to_tensor_transform: str = "yes"
    bound_expand_limit: int = 0
    axis_for_limit: str = "z"
    use_3d_mode: bool = False
    path_to_slices_info: str = "configs/SlicesInfoZ.txt"
    limited_slices: bool = True
    do_resize: str = "no"
    use_normalize: str = "no"
    CenterCrop: str = "no"
    image_size: int = 64
    num_channels: int = 1
    centered: bool = True
    # diffusion
    use_geometric: bool = False
    beta_min: float = 0.1
    beta_max: float = 20.0
    num_timesteps: int = 1
    # extension (not in the reference schema): 'float32' or 'bfloat16'
    # compute dtype for the model conv/attention path; params, norms
    # statistics, losses and the optimizer always stay float32.
    compute_dtype: str = "float32"
    # perf/memory knobs of the JAX package (not in the reference schema).
    # Accepted so its config files load unchanged; none of them changes
    # what the port computes.
    use_remat: Any = "auto"  # "auto" = off in the port (slower on the H100); yes/no force
    remat_policy: str = "full"  # "full" | "save-convs" (conv outputs kept, not recomputed)
    s2d_conv: str = "auto"  # width-s2d region closure: "auto" (on where eligible) | "off"
    r1_shared: str = "auto"  # shared-R1 vjp forward: "auto" (on at ≥256²) | "yes" | "no"
    optimizer_sharding: str = "replicated"  # "replicated" | "zero1" (ZeRO-1 sharded Adam moments)
    # generator (NCSN++)
    num_channels_dae: int = 128
    n_mlp: int = 4
    num_res_blocks: int = 2
    attn_resolutions: List[int] = dataclasses.field(default_factory=lambda: [16])
    dropout: float = 0.05
    resamp_with_conv: bool = True
    conditional: bool = True
    fir: bool = True
    fir_kernel: List[int] = dataclasses.field(default_factory=lambda: [1, 3, 3, 1])
    skip_rescale: bool = True
    resblock_type: str = "biggan"
    progressive: str = "none"
    progressive_input: str = "residual"
    progressive_combine: str = "sum"
    embedding_type: str = "positional"
    fourier_scale: float = 16.0
    not_use_tanh: bool = False
    nz: int = 100
    z_emb_dim: int = 256
    ch_mult: List[int] = dataclasses.field(default_factory=lambda: [1, 2, 2, 2])
    # discriminator
    disc_small: str = "yes"
    t_emb_dim: int = 256
    ngf: int = 64
    # optimization
    batch_size: int = 16
    num_epoch: int = 2
    lr_g: float = 3e-4
    lr_d: float = 2e-4
    beta1: float = 0.0
    beta2: float = 0.9
    no_lr_decay: bool = False
    use_ema: bool = True
    ema_decay: float = 0.01
    r1_gamma: float = 10.0
    lazy_reg: Any = 16
    grad_clip_norm: float = 1.0
    weight_decay_G: float = 0.0
    weight_decay_D: float = 0.0
    beta1_g: float = 0.5
    beta2_g: float = 0.999
    beta1_d: float = 0.5
    beta2_d: float = 0.999
    d_updates_per_g_update: int = 1
    # checkpointing
    save_content: bool = True
    save_content_every: int = 1
    save_ckpt_every: int = 1
    # distributed (reference DDP surface)
    distributed: bool = False
    what_backend: str = "nccl"
    num_proc_node: int = 1
    num_process_per_node: int = 1
    node_rank: int = 0
    local_rank: int = 0
    master_address: str = "127.0.0.1"

    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        """Build from a dict, keeping unknown keys as extra attributes.

        The reference constructs argparse.Namespace(**config) — unknown keys
        are legal and simply become attributes (train_ddgan.py:222).
        """
        known = {f.name for f in dataclasses.fields(cls)}
        cfg = cls(**{k: v for k, v in d.items() if k in known})
        for k, v in d.items():
            if k not in known:
                object.__setattr__(cfg, k, v)
        return cfg

    @classmethod
    def load(cls, path: str | Path) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save(self, path: str | Path) -> None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        with open(p, "w") as f:
            json.dump(self.to_dict(), f, indent=4)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def default_config() -> Config:
    return Config()


# JSON helpers with the reference's read-update-write semantics
# (additionals/utilities.py:123-162).
def load_json_to_dict(path: str | Path) -> dict:
    with open(path) as f:
        return json.load(f)


def save_dict_to_json(d: dict, path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(d, f, indent=4)


def modify_json_file(path: str | Path, updates: dict) -> dict:
    """Read-update-write a JSON config in place (utilities.py:150-162)."""
    d = load_json_to_dict(path)
    d.update(updates)
    save_dict_to_json(d, path)
    return d
