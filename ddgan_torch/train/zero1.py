"""ZeRO-1: the Adam moments sharded over the ranks. Counterpart of
`ddgan_tpu/train/zero1.py`.

`ClippedAdam` (`train/optim.py`) keeps both moments of every parameter on
every rank: 2·P float32 per network per GPU. `Zero1Adam` keeps a 1/R slice
of them, ⌈P/R⌉ floats of each moment per rank, and computes the same update
as the JAX package's `zero1_update_sharded` (`zero1.py:96-155`):

  1. the gradients, flattened to float32 in parameter order and padded to
     R·⌈P/R⌉ (the JAX package's `_pack_rows` layout), go through one
     `reduce_scatter_tensor`, then are divided by R: rank r holds slice r of
     the mean gradient;
  2. the clip by the global norm of the mean gradient, from an all-reduce of
     the slice's sum of squares: exact, no epsilon, a scale only when the
     norm exceeds the bound (`zero1.py:123-129`);
  3. torch-style L2: wd · (rank r's slice of the parameters) is added;
  4. Adam on the slice: the moments, the bias corrections, and
     mu_hat / (sqrt(nu_hat) + eps). That is not torch's `Adam` formula
     (lr/bc1 · m / (sqrt(v)/sqrt(bc2) + eps)), so this optimizer and
     `ClippedAdam` agree to rounding, not bit for bit, as in the JAX package
     (tests/test_zero1.py);
  5. one `all_gather_into_tensor` of the update slices, then p -= lr · update.

The reduce-scatter and the all-gather move the bytes of the all-reduce that
`ClippedAdam` pays. The slice order is the port's parameter order.

`state_dict()` is a collective: every rank gathers the moments and gets
the reference's `torch.optim.Adam` state dict (per-parameter `exp_avg`,
`exp_avg_sq`, `step`); `load_state_dict` takes that format and keeps this
rank's slice. So `content.pth` has the reference's format in either mode and
at any world size, and a run resumes across modes and world sizes with no
converter: the port's counterpart of the JAX package's
`_adapt_one_opt` (`ddgan_tpu/train/checkpoint.py:114-212`). Without a group
it runs with R = 1 and no collectives, as JAX's one-device mesh does.
"""

from __future__ import annotations

import copy
from typing import Iterable

import torch
import torch.distributed as dist

from ..parallel.mesh import all_gather_, reduce_scatter_


class Zero1Adam:
    """`ClippedAdam`'s interface (`zero_grad`, `step(lr)`, `state_dict`,
    `load_state_dict`) with the moments sharded over the ranks of `group`."""

    eps = 1e-8

    def __init__(self, params: Iterable[torch.nn.Parameter], beta1: float, beta2: float,
                 weight_decay: float = 0.0, grad_clip_norm: float | None = 1.0, group=None):
        self.params = list(params)
        self.beta1, self.beta2 = float(beta1), float(beta2)
        self.weight_decay = float(weight_decay)
        self.grad_clip_norm = grad_clip_norm
        self.group = group
        self.world = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)
        self.sizes = [p.numel() for p in self.params]
        self.total = sum(self.sizes)
        self.shard = -(-self.total // self.world)
        dev = self.params[0].device
        self.mu = torch.zeros(self.shard, dtype=torch.float32, device=dev)
        self.nu = torch.zeros(self.shard, dtype=torch.float32, device=dev)
        self.count = 0
        # the param_groups of the reference's optimizer, for its state dict
        self.param_groups = torch.optim.Adam(
            self.params, lr=0.0, betas=(beta1, beta2), eps=self.eps,
            weight_decay=weight_decay).state_dict()["param_groups"]

    def _flat(self, tensors) -> torch.Tensor:
        """`tensors` as one float32 vector padded to R·⌈P/R⌉."""
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        return torch.nn.functional.pad(flat, (0, self.world * self.shard - self.total))

    def _slice(self, flat: torch.Tensor) -> torch.Tensor:
        return flat[self.rank * self.shard:(self.rank + 1) * self.shard]

    def _gather(self, local: torch.Tensor) -> torch.Tensor:
        if self.group is None:
            return local
        out = local.new_empty(self.world * self.shard)
        all_gather_(out, local, self.group)
        return out

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def update(self) -> torch.Tensor:
        """Steps 1-4 and the gather: the full preconditioned update (P,)
        float32, from the parameters' `.grad` (zeros where there is none)."""
        g = self._flat(p.grad if p.grad is not None else torch.zeros_like(p)
                       for p in self.params)
        if self.group is not None:
            out = g.new_empty(self.shard)
            reduce_scatter_(out, g, self.group)
            g = out
        g = g / self.world
        if self.grad_clip_norm is not None and self.grad_clip_norm > 0:
            sq = torch.sum(g * g)
            if self.group is not None:
                dist.all_reduce(sq, group=self.group)
            norm = torch.sqrt(sq)
            g = g * torch.where(norm < self.grad_clip_norm, torch.ones_like(norm),
                                self.grad_clip_norm / norm)
        if self.weight_decay:
            g = g + self.weight_decay * self._slice(self._flat(self.params))
        self.count += 1
        self.mu = self.beta1 * self.mu + (1.0 - self.beta1) * g
        self.nu = self.beta2 * self.nu + (1.0 - self.beta2) * (g * g)
        # the bias corrections in float32, as the JAX package computes them
        c = torch.tensor(float(self.count), device=g.device)
        mu_hat = self.mu / (1.0 - torch.tensor(self.beta1, device=g.device) ** c)
        nu_hat = self.nu / (1.0 - torch.tensor(self.beta2, device=g.device) ** c)
        return self._gather(mu_hat / (torch.sqrt(nu_hat) + self.eps))[:self.total]

    @torch.no_grad()
    def apply_(self, update: torch.Tensor, lr: float) -> None:
        """p -= lr · update (`update()`'s flat vector), in parameter order."""
        for p, u in zip(self.params, update.split(self.sizes)):
            p.sub_(u.view_as(p) * lr)
        self.param_groups[0]["lr"] = float(lr)

    def step(self, lr: float) -> None:
        self.apply_(self.update(), lr)

    def state_dict(self) -> dict:
        """The reference's `torch.optim.Adam` state dict of the full moments
        (a collective: every rank of the group must call it)."""
        state = {}
        if self.count:
            mu, nu = self._gather(self.mu), self._gather(self.nu)
            off = 0
            for i, p in enumerate(self.params):
                n = p.numel()
                state[i] = {"step": torch.tensor(float(self.count)),
                            "exp_avg": mu[off:off + n].view_as(p).clone(),
                            "exp_avg_sq": nu[off:off + n].view_as(p).clone()}
                off += n
        return {"state": state, "param_groups": copy.deepcopy(self.param_groups)}

    def load_state_dict(self, state_dict: dict) -> None:
        """Load a `torch.optim.Adam` state dict of these parameters, keeping
        this rank's slice of the moments."""
        groups = state_dict["param_groups"]
        if len(groups) != 1 or len(groups[0]["params"]) != len(self.params):
            raise ValueError(f"the state dict holds {[len(g['params']) for g in groups]} "
                             f"parameters in its groups; this optimizer has {len(self.params)}")
        state = state_dict["state"]
        if not state:
            self.mu.zero_()
            self.nu.zero_()
            self.count = 0
        else:
            ids = groups[0]["params"]
            sizes = [state[i]["exp_avg"].numel() for i in ids]
            if sizes != self.sizes:
                raise ValueError("the state dict's moments do not have this optimizer's "
                                 "parameter sizes")
            for key, moment in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
                flat = self._flat(state[i][key].to(self.mu.device) for i in ids)
                setattr(self, moment, self._slice(flat).clone())
            self.count = int(state[ids[0]]["step"])
        self.param_groups = [{**copy.deepcopy(groups[0]),
                              "params": list(range(len(self.params)))}]
