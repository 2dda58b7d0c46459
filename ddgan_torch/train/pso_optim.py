"""AdaptivePSO — the reference's gradient-free inner optimizer (reference:
pso_optim.py), as the JAX package runs it (`ddgan_tpu/train/pso_optim.py`).

The semantics are the JAX package's, quirks included:
  * the velocity is taken relative to the MODEL's parameters, not to the
    particle's own position: v = w*v + c1*r1*(pbest_i - p) + c2*r2*(gbest - p)
    (pso_optim.py:103-107 uses `p.data`);
  * the fitness of particle i is the i-th accumulated batch loss, all of
    them taken under the same model parameters (ddgan.py:491-493, :513-515),
    the first `swarm_size` of the losses given;
  * the global best evolves within the per-particle loop (particle j sees
    the best of particles k < j): a prefix minimum over the swarm with strict
    '<' ties, over the pre-update positions (pso_optim.py:94-99);
  * velocities and positions are clamped; c1 and c2 adapt by the share of
    particles whose personal best improved (pso_optim.py:120-134);
  * the global best starts at the parameters and is copied into them after
    the update (pso_optim.py:136-140).

The swarm lives on the parameters' device as one tensor per parameter with
a leading swarm axis, in `module.parameters()` order. The update runs one
parameter at a time, so the per-particle global best and the uniform draws
r1, r2 exist for one parameter at a time only. Every scalar of the state
(scores, c1, c2, the iteration) is a device tensor, so a step never waits
for the device. Draws come from an explicit `torch.Generator` on the
device; tests inject them instead (`PSODraws`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch


@dataclasses.dataclass
class PSOState:
    particles: list[torch.Tensor]  # each (swarm, *param_shape)
    velocities: list[torch.Tensor]
    pbest_pos: list[torch.Tensor]
    pbest_scores: torch.Tensor  # (swarm,) float32
    gbest_pos: list[torch.Tensor]  # each param_shape
    gbest_score: torch.Tensor  # () float32
    c1: torch.Tensor  # () float32
    c2: torch.Tensor
    iteration: torch.Tensor  # () int32


class PSODraws(NamedTuple):
    """The uniform draws of one swarm step, one (swarm, *shape) tensor per
    parameter for r1 and for r2."""

    r1: Sequence[torch.Tensor]
    r2: Sequence[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdaptivePSO:
    swarm_size: int = 20
    inertia_weight: float = 0.729
    inertia_weight_strategy: str = "constant"
    c1: float = 1.49445
    c1_min: float = 1.0
    c1_max: float = 2.0
    c2: float = 1.49445
    c2_min: float = 1.0
    c2_max: float = 2.0
    max_iter: int = 1000
    weight_decay: float = 0.0  # parsed-but-unused in the reference too
    velocity_clamp: tuple[float, float] | None = (-1.0, 1.0)
    position_clamp: tuple[float, float] | None = (-10.0, 10.0)
    threshold_low: float = 0.2
    threshold_high: float = 0.5
    c_adjust_step: float = 0.05

    @torch.no_grad()
    def init(self, params: Sequence[torch.Tensor], generator: torch.Generator | None = None,
             noise: Sequence[torch.Tensor] | None = None) -> PSOState:
        """particles = params + 0.05 * N(0, 1) (pso_optim.py:44-65); `noise`
        injects the N(0, 1) draws, one (swarm, *shape) tensor per parameter."""
        s = self.swarm_size
        particles = []
        for i, p in enumerate(params):
            n = noise[i].to(p) if noise is not None else torch.randn(
                (s,) + tuple(p.shape), generator=generator, device=p.device, dtype=p.dtype)
            particles.append(p.detach()[None] + 0.05 * n)
        dev = params[0].device
        return PSOState(
            particles=particles,
            velocities=[torch.zeros_like(x) for x in particles],
            pbest_pos=[x.clone() for x in particles],
            pbest_scores=torch.full((s,), float("inf"), device=dev),
            gbest_pos=[p.detach().clone() for p in params],
            gbest_score=torch.tensor(float("inf"), device=dev),
            c1=torch.tensor(self.c1, dtype=torch.float32, device=dev),
            c2=torch.tensor(self.c2, dtype=torch.float32, device=dev),
            iteration=torch.zeros((), dtype=torch.int32, device=dev),
        )

    @torch.no_grad()
    def step(self, state: PSOState, params: Sequence[torch.Tensor], loss_values: torch.Tensor,
             generator: torch.Generator | None = None, draws: PSODraws | None = None) -> None:
        """One swarm update of `state` and `params`, in place.

        loss_values: at least `swarm_size` fitness values (the accumulated
        batch losses; the first swarm_size are used)."""
        s = self.swarm_size
        dev = state.pbest_scores.device
        loss = loss_values[:s].to(device=dev, dtype=torch.float32)

        if self.inertia_weight_strategy == "linear":
            w = 0.9 - (0.9 - 0.4) * state.iteration.float() / self.max_iter
        else:
            w = torch.tensor(self.inertia_weight, dtype=torch.float32, device=dev)

        # personal bests (pso_optim.py:88-92)
        improved = loss < state.pbest_scores
        state.pbest_scores = torch.where(improved, loss, state.pbest_scores)

        # the global best each particle sees: a prefix minimum, strict '<'
        prefix_min = torch.cummin(loss, 0).values
        prev_min = torch.cat([loss.new_full((1,), float("inf")), prefix_min[:-1]])
        improved_glob = loss < torch.minimum(state.gbest_score, prev_min)
        masked_idx = torch.where(improved_glob, torch.arange(s, device=dev),
                                 torch.full((s,), -1, device=dev, dtype=torch.long))
        prefix_arg = torch.cummax(masked_idx, 0).values
        use_new = prefix_arg >= 0
        gather_idx = prefix_arg.clamp(min=0)
        final_better = prefix_arg[-1] >= 0
        final_idx = prefix_arg[-1].clamp(min=0)
        state.gbest_score = torch.minimum(prefix_min[-1], state.gbest_score)

        vmin, vmax = self.velocity_clamp or (None, None)
        pmin, pmax = self.position_clamp or (None, None)
        for i, p in enumerate(params):
            part, vel, pb, gb = (state.particles[i], state.velocities[i], state.pbest_pos[i],
                                 state.gbest_pos[i])
            lead = (-1,) + (1,) * p.dim()
            pb.copy_(torch.where(improved.view(lead), part, pb))
            gb_seen = torch.where(use_new.view(lead), part[gather_idx], gb[None])
            if draws is not None:
                r1, r2 = draws.r1[i].to(part), draws.r2[i].to(part)
            else:
                r1 = torch.rand(part.shape, generator=generator, device=dev, dtype=part.dtype)
                r2 = torch.rand(part.shape, generator=generator, device=dev, dtype=part.dtype)
            cognitive = state.c1 * r1 * (pb - p[None])
            social = state.c2 * r2 * (gb_seen - p[None])
            v = w * vel + cognitive + social
            if self.velocity_clamp is not None:
                v = v.clamp(vmin, vmax)
            gb.copy_(torch.where(final_better, part[final_idx], gb))
            part.add_(v)
            if self.position_clamp is not None:
                part.clamp_(pmin, pmax)
            vel.copy_(v)
            p.copy_(gb)  # the global best into the parameters (pso_optim.py:136-140)

        # c1/c2 adaptation (pso_optim.py:120-134)
        ratio = improved.sum().float() / s
        low, high = ratio < self.threshold_low, ratio > self.threshold_high
        c1, c2, step = state.c1, state.c2, self.c_adjust_step
        state.c1 = torch.where(low, torch.clamp(c1 + step, max=self.c1_max),
                               torch.where(high, torch.clamp(c1 - step, min=self.c1_min), c1))
        state.c2 = torch.where(low, torch.clamp(c2 - step, min=self.c2_min),
                               torch.where(high, torch.clamp(c2 + step, max=self.c2_max), c2))
        state.iteration = state.iteration + 1

    def draws(self, params: Sequence[torch.Tensor],
              generator: torch.Generator | None = None) -> PSODraws:
        """The r1 and r2 that `step` would draw from `generator`, drawn in its
        order (r1 then r2, parameter by parameter) and materialised, for a
        check that replays one step on another device."""
        r1, r2 = [], []
        for p in params:
            shape = (self.swarm_size,) + tuple(p.shape)
            r1.append(torch.rand(shape, generator=generator, device=p.device, dtype=p.dtype))
            r2.append(torch.rand(shape, generator=generator, device=p.device, dtype=p.dtype))
        return PSODraws(r1, r2)
