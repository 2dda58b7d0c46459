"""The first Adam step of DiscriminatorLarge at the CelebA-HQ 256 recipe's
lr, in bf16 and in f32, in the port and in the JAX package, on the CPU.

Adam's first update is about lr · sign(g) for every weight. D's update
gradient is a difference of two near-equal terms (the real and the fake
batch, both at D ≈ 0 from the init), so for many weights bf16 rounding
decides the sign, and the first step moves D's output by a different
amount in bf16 than in f32. The JAX package does this too: here, at 64²
and ngf 16, its bf16 step lands 17% of the step's move away from its f32
step (the move is ~0.08 in errG'), the port's 1.9%; the two round at
different places, and JAX's bf16 gradient flips more signs (4.1% of the
weights against the port's 2.2%). At the full-width 256² recipe the same
step moves errG by ~57 and the port's two precisions end ~10 apart
(`chip_smoke.py` phase 23).

Setup: DiscriminatorLarge(ngf 16, t_emb_dim 256) at 64² (its minimum),
batch 4, the JAX package's own init (PRNGKey 0) carried to the port with a
strict load; the update loss is errD_real + errD_fake + the R1 penalty
(gamma 2); Adam betas (0.5, 0.999), clip 1, lr 2e-4 (the recipe's lr_d).
errG' = softplus(-D(x_g)).mean() on a held-out batch, evaluated in f32
after the step. Bounds:
- f32: the port's errG' after its step equals JAX's within 1% of the move
  (the same signs but for gradients at the f32 noise floor);
- JAX's bf16 step lands at least 5% of the move away from its f32 step;
- the port's bf16 step is no farther from its f32 step than JAX's is
  (within 1.5×), and not on it (bf16 rounding flips some signs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
import torch.nn.functional as F

from ddgan_tpu.models import DiscriminatorLarge as JLarge
from ddgan_tpu.train import make_optimizer as jmake_optimizer
from ddgan_tpu.train.optim import apply_lr

from ddgan_torch.compat import state_dict_from_flax
from ddgan_torch.models import DiscriminatorLarge
from ddgan_torch.train import ClippedAdam

from _torch_port import nchw, one_torch_thread  # noqa: F401

NGF, SIDE, B = 16, 64, 4
LR_D, R1_GAMMA = 2e-4, 2.0


def _batch():
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (B, SIDE, SIDE, 3)).astype(np.float32)  # x_t, the real side
    x_cond = rs.randn(B, SIDE, SIDE, 3).astype(np.float32)  # x_{t+1}
    x_f = (0.5 * rs.randn(B, SIDE, SIDE, 3)).astype(np.float32)  # the fakes
    x_g = (0.5 * rs.randn(B, SIDE, SIDE, 3)).astype(np.float32)  # the G update's fakes
    return x, x_cond, x_f, x_g, np.array([0, 1, 0, 1], np.int32)


def _jax_side(params, x, x_cond, x_f, x_g, t):
    """errG' before, after the f32 step and after the bf16 step; the two
    gradients."""
    def apply(jd, p, a):
        return jd.apply({"params": p}, a, jnp.asarray(t), jnp.asarray(x_cond)).reshape(-1).astype(
            jnp.float32)

    def grads(jd):
        def loss(p):
            g = jax.grad(lambda a: apply(jd, p, a).sum())(jnp.asarray(x))
            penalty = R1_GAMMA / 2 * (g.astype(jnp.float32).reshape(B, -1) ** 2).sum(1).mean()
            return (jax.nn.softplus(-apply(jd, p, jnp.asarray(x))).mean()
                    + jax.nn.softplus(apply(jd, p, jnp.asarray(x_f))).mean() + penalty)

        return jax.jit(jax.grad(loss))(params)

    j32 = JLarge(nc=6, ngf=NGF, t_emb_dim=256)
    err_g = jax.jit(lambda p: jax.nn.softplus(-apply(j32, p, jnp.asarray(x_g))).mean())
    tx = jmake_optimizer(0.5, 0.999, 0.0, 1.0)
    out = {"before": float(err_g(params))}
    for name, dtype in (("f32", None), ("bf16", jnp.bfloat16)):
        g = grads(JLarge(nc=6, ngf=NGF, t_emb_dim=256, dtype=dtype))
        upd, _ = tx.update(g, tx.init(params), params)
        out[name] = float(err_g(optax.apply_updates(params, apply_lr(upd, LR_D))))
        out["grad_" + name] = np.concatenate([np.asarray(a).ravel() for a in jax.tree.leaves(g)])
    return out


def _port_side(sd, x, x_cond, x_f, x_g, t):
    tt, xc = torch.from_numpy(t).long(), nchw(x_cond)
    d32 = DiscriminatorLarge(nc=6, ngf=NGF, t_emb_dim=256)
    d32.load_state_dict(sd, strict=True)

    def err_g():
        with torch.no_grad():
            return float(F.softplus(-d32(nchw(x_g), tt, xc).reshape(-1)).mean())

    out = {"before": err_g()}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        disc = DiscriminatorLarge(nc=6, ngf=NGF, t_emb_dim=256, dtype=dtype)
        disc.load_state_dict(sd, strict=True)
        xi = nchw(x).requires_grad_(True)
        d_real = disc(xi, tt, xc).reshape(-1).float()
        (g,) = torch.autograd.grad(d_real.sum(), xi, create_graph=True)
        penalty = R1_GAMMA / 2 * g.float().reshape(B, -1).square().sum(1).mean()
        loss = (F.softplus(-d_real).mean()
                + F.softplus(disc(nchw(x_f), tt, xc).reshape(-1).float()).mean() + penalty)
        loss.backward(inputs=list(disc.parameters()))
        out["grad_" + name] = torch.cat([p.grad.reshape(-1) for p in disc.parameters()]).numpy()
        ClippedAdam(disc.parameters(), 0.5, 0.999, 0.0, 1.0).step(LR_D)
        d32.load_state_dict(disc.state_dict(), strict=True)
        out[name] = err_g()
    return out


def test_bf16_first_adam_step_separates_no_further_than_jax():
    x, x_cond, x_f, x_g, t = _batch()
    params = JLarge(nc=6, ngf=NGF, t_emb_dim=256).init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t), jnp.asarray(x_cond))["params"]
    want = _jax_side(params, x, x_cond, x_f, x_g, t)
    got = _port_side(state_dict_from_flax(jax.tree.map(np.asarray, params)), x, x_cond, x_f, x_g,
                     t)

    move = want["f32"] - want["before"]
    sep_jax = abs(want["bf16"] - want["f32"]) / abs(move)
    sep_port = abs(got["bf16"] - got["f32"]) / abs(got["f32"] - got["before"])
    flips = {side: float((np.sign(d["grad_f32"]) != np.sign(d["grad_bf16"])).mean())
             for side, d in (("jax", want), ("port", got))}
    print(f"errG' before {want['before']:.6f} / {got['before']:.6f}; after the f32 step JAX "
          f"{want['f32']:.6f} port {got['f32']:.6f}; after the bf16 step JAX {want['bf16']:.6f} "
          f"port {got['bf16']:.6f}; separation / move: JAX {sep_jax:.4f} port {sep_port:.4f}; "
          f"gradient signs that bf16 flips: {flips}")
    assert abs(got["before"] - want["before"]) <= 1e-5
    assert abs(move) > 1e-2, "the first step did not move D: the comparison would be vacuous"
    assert abs(got["f32"] - want["f32"]) <= 1e-2 * abs(move)
    assert sep_jax >= 0.05
    assert sep_port <= 1.5 * sep_jax and flips["port"] > 1e-3
