"""DDGAN's train step in plain PyTorch (ddgan.py:438-522 of
NVlabs/denoising-diffusion-gan, with the lazy R1 of its documented intent
and gradients clipped by their global norm before each Adam step).

One step: draw t, the two q-noises, z and the posterior noise for the D
update, then the same for the G update, from the step's generator, in that
order; then

  D: fakes from G (no gradient) through the posterior;
     softplus(D(x_pos)).mean() + softplus(-D(x_t)).mean(), and on an R1
     step r1_gamma/2 * E ||d sum D(x_t) / d x_t||^2 from the same D(x_t);
     clip, Adam.
  G: fresh pairs and z; softplus(-D(x_pos_g)).mean() against the updated D;
     clip, Adam; then the EMA of G.

The batch may run in chunks to bound memory (`rows`): a chunk holds whole
groups of the discriminator's minibatch-stddev (rows j, j + B/4, ... for a
set of j), G's dropout masks are drawn for the whole batch (`Ops`), and
each loss is summed over the chunks' rows and divided by the batch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .diffusion import Schedule, posterior, q_pairs


class Adam:
    """Clip by the global norm (scale max_norm / norm when norm >= max_norm),
    L2 weight decay into the gradient, then Adam (eps 1e-8), step size lr."""

    def __init__(self, params, b1: float, b2: float, weight_decay: float, clip: float | None):
        self.params = list(params)
        self.b1, self.b2, self.wd, self.clip = b1, b2, weight_decay, clip
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0
        self.last_grads: list[torch.Tensor] = []

    @torch.no_grad()
    def step(self, lr: float) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.clip:
            norm = torch.sqrt(sum(g.double().square().sum() for g in grads)).float()
            scale = torch.clamp(self.clip / norm, max=1.0)
            grads = [g * scale for g in grads]
        self.last_grads = grads
        self.t += 1
        bc1, bc2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            if self.wd:
                g = g + self.wd * p
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(lr / bc1 * m / (torch.sqrt(v / bc2) + 1e-8))
        for p in self.params:
            p.grad = None


def draw(batch_shape, T: int, nz: int, gen, device):
    """The step's draws, D update's then G update's: t, noise_q, noise_next,
    z, noise_post each."""
    b = batch_shape[0]
    out = []
    for _ in range(2):
        out.append(torch.randint(0, T, (b,), generator=gen, device=device))
        out.append(torch.randn(batch_shape, generator=gen, device=device))
        out.append(torch.randn(batch_shape, generator=gen, device=device))
        out.append(torch.randn((b, nz), generator=gen, device=device))
        out.append(torch.randn(batch_shape, generator=gen, device=device))
    return out


def chunks(batch: int, rows: int | None, device) -> list:
    """Index sets of about `rows` rows that hold whole stddev groups (rows
    j, j + B/4, j + 2B/4, j + 3B/4), in group-major order; the whole batch
    as one slice when `rows` is None or covers it."""
    if rows is None or rows >= batch:
        return [slice(None)]
    g = min(batch, 4)
    cols = batch // g
    per = max(1, rows // g)
    out = []
    for a in range(0, cols, per):
        j = torch.arange(a, min(a + per, cols), device=device)
        out.append((torch.arange(g, device=device)[:, None] * cols + j[None]).reshape(-1))
    return out


class TrainStep:
    """The reference step over G, D, their `Adam`s and G's EMA (a list of
    tensors in G's parameter order)."""

    def __init__(self, G, D, opt_G: Adam, opt_D: Adam, ema, sched: Schedule, ops, *,
                 nz: int, r1_gamma: float, lazy_reg: int | None, ema_decay: float,
                 rows: int | None = None):
        self.G, self.D, self.opt_G, self.opt_D, self.ema = G, D, opt_G, opt_D, ema
        self.s, self.ops, self.nz, self.rows = sched, ops, nz, rows
        self.r1_gamma, self.lazy_reg, self.ema_decay = r1_gamma, lazy_reg, ema_decay
        self.step_count = 0

    def __call__(self, real, gen, lr_g: float, lr_d: float) -> dict:
        G, D, s, ops = self.G, self.D, self.s, self.ops
        G.train()
        D.train()
        b = real.shape[0]
        t, nq, nn_, z, npost, t_g, nq_g, nn_g, z_g, npost_g = draw(
            real.shape, s.T, self.nz, gen, real.device)
        r1 = self.lazy_reg is None or self.step_count % self.lazy_reg == 0
        parts = chunks(b, self.rows, real.device)
        d_params = list(D.parameters())
        g_params = list(G.parameters())

        # D update
        x_t, x_tp1 = q_pairs(s, real, t, nq, nn_)
        with torch.no_grad():
            x_pos = torch.empty_like(real)
            ops.begin_masks(b)
            for idx in parts:
                ops.use_rows(idx)
                x0 = G(ops, x_tp1[idx], t[idx], z[idx])
                x_pos[idx] = posterior(s, x0, x_tp1[idx], t[idx], npost[idx])
        fake_sum = real_sum = gp_sum = 0.0
        for idx in parts:
            fake = F.softplus(D(ops, x_pos[idx], t[idx], x_tp1[idx])).sum()
            xr = x_t[idx].detach().requires_grad_(r1)
            d_real = D(ops, xr, t[idx], x_tp1[idx])
            real_l = F.softplus(-d_real).sum()
            loss = fake + real_l
            if r1:
                (grad,) = torch.autograd.grad(d_real.sum(), xr, create_graph=True)
                gp = grad.reshape(grad.shape[0], -1).square().sum(1).sum()
                loss = loss + self.r1_gamma / 2.0 * gp
                gp_sum += gp.detach()
            (loss / b).backward(inputs=d_params)
            fake_sum += fake.detach()
            real_sum += real_l.detach()
        self.opt_D.step(lr_d)

        # G update
        _, x_tp1_g = q_pairs(s, real, t_g, nq_g, nn_g)
        err_g = 0.0
        ops.begin_masks(b)
        for idx in parts:
            ops.use_rows(idx)
            x0 = G(ops, x_tp1_g[idx], t_g[idx], z_g[idx])
            xp = posterior(s, x0, x_tp1_g[idx], t_g[idx], npost_g[idx])
            e = F.softplus(-D(ops, xp, t_g[idx], x_tp1_g[idx])).sum()
            (e / b).backward(inputs=g_params)
            err_g += e.detach()
        self.opt_G.step(lr_g)
        with torch.no_grad():
            for e_, p in zip(self.ema, g_params):
                e_.mul_(self.ema_decay).add_(p, alpha=1.0 - self.ema_decay)
        self.step_count += 1
        gp = self.r1_gamma / 2.0 * gp_sum / b if r1 else torch.zeros(())
        return {"errD": (fake_sum + real_sum) / b, "errG": err_g / b, "grad_penalty": gp}


def leaf_norms(tensors) -> list[float]:
    """Euclidean norm of each tensor, in float64."""
    return [math.sqrt(float(x.double().square().sum())) for x in tensors]
