"""The port's AdaptivePSO (`ddgan_torch.train.pso_optim`) against the JAX
package's (`ddgan_tpu.train.pso_optim`), on the CPU.

The same parameters and the same draws go through both over several steps:
the init noise is `jax.random.normal` under the keys `init` splits, and r1,
r2 are `jax.random.uniform` under the keys `step` splits (2n keys, r1's
first), injected into the port as `PSODraws`. The loss sequences cover a
first step where every particle improves (c1 down, c2 up), one where none
does (c1 up, c2 down), equal fitness values (strict '<' ties in the
personal and the global best), an all-inf epoch and a mixed one; the
options cover the clamps off, clamps tight enough to bind, and the linear
inertia. The JAX step runs op by op: each elementwise float32 operation
is then correctly rounded, as in the port, and the two agree to the last
bit here; under `jax.jit` XLA fuses the velocity update and rounds it
otherwise (up to 1.3e-6 of max|ref| after six steps). Bound: every state
tensor and parameter within 1e-6 of its largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddgan_tpu.train.pso_optim import AdaptivePSO as JAdaptivePSO

from ddgan_torch.train.pso_optim import AdaptivePSO, PSODraws

from _torch_port import one_torch_thread  # noqa: F401  (an autouse fixture)

SWARM = 5
SHAPES = {"a": (5,), "b": (3, 4), "c": (2, 3, 3, 2)}  # flattened a, b, c (sorted keys)
INF = np.inf
LOSSES = [
    [0.9, 0.7, 1.1, 0.8, 1.0],  # every particle improves from inf: ratio 1 > 0.5
    [2.0, 2.0, 2.0, 2.0, 0.6],  # one improves: ratio 0.2, neither threshold
    [3.0, 3.0, 3.0, 3.0, 3.0],  # none improves: ratio 0 < 0.2
    [0.5, 0.5, 0.4, 0.4, 0.9],  # ties: the first of equal scores keeps the best
    [INF] * SWARM,  # an epoch without losses, +inf-padded
    [0.3, INF, 0.3, 0.2, INF, 7.0, 7.0],  # more losses than particles: the first SWARM
]
OPTIONS = {
    "default": {},
    "no_clamps": dict(velocity_clamp=None, position_clamp=None),
    "tight_clamps": dict(velocity_clamp=(-0.02, 0.02), position_clamp=(-0.3, 0.3)),
    "linear_inertia": dict(inertia_weight_strategy="linear", max_iter=4),
}


def _params(seed):
    rs = np.random.RandomState(seed)
    return {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _jax_draws(key, params, n_keys_dist):
    """What `init` (normal) or `step` (uniform, r1 then r2) draw under `key`."""
    leaves = jax.tree.leaves(params)
    n = len(leaves)
    if n_keys_dist == "normal":
        keys = jax.random.split(key, n)
        return [np.asarray(jax.random.normal(k, (SWARM,) + p.shape, p.dtype))
                for p, k in zip(leaves, keys)]
    keys = jax.random.split(key, 2 * n)
    return PSODraws(
        [torch.tensor(np.asarray(jax.random.uniform(k, (SWARM,) + p.shape, p.dtype)))
         for p, k in zip(leaves, keys[:n])],
        [torch.tensor(np.asarray(jax.random.uniform(k, (SWARM,) + p.shape, p.dtype)))
         for p, k in zip(leaves, keys[n:])])


def _check(name, got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    assert np.array_equal(np.isinf(got), np.isinf(want)), name
    fin = np.isfinite(want)
    scale = max(float(np.abs(want[fin]).max(initial=0.0)), 1e-30)
    err = float(np.abs(got[fin] - want[fin]).max(initial=0.0))
    assert err <= 1e-6 * scale, f"{name}: max-abs {err} against max|ref| {scale}"


def _compare(jstate, jparams, state, params, step):
    for field in ("particles", "velocities", "pbest_pos", "gbest_pos"):
        for i, (g, w) in enumerate(zip(getattr(state, field), _leaves(getattr(jstate, field)))):
            _check(f"step {step} {field}[{i}]", g, w)
    for field in ("pbest_scores", "gbest_score", "c1", "c2"):
        _check(f"step {step} {field}", getattr(state, field), getattr(jstate, field))
    assert int(state.iteration) == int(jstate.iteration) and state.iteration.dtype == torch.int32
    for i, (g, w) in enumerate(zip(params, _leaves(jparams))):
        _check(f"step {step} params[{i}]", g.detach(), w)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_swarm_steps_match_jax(option):
    jpso = JAdaptivePSO(swarm_size=SWARM, **OPTIONS[option])
    pso = AdaptivePSO(swarm_size=SWARM, **OPTIONS[option])
    jparams = jax.tree.map(jnp.asarray, _params(0))
    params = [torch.from_numpy(a.copy()).requires_grad_(True) for a in _leaves(jparams)]

    key = jax.random.PRNGKey(3)
    jstate = jpso.init(key, jparams)
    state = pso.init(params, noise=[torch.tensor(n) for n in _jax_draws(key, jparams, "normal")])
    _compare(jstate, jparams, state, params, "init")

    c_moves = []
    for i, losses in enumerate(LOSSES):
        key = jax.random.PRNGKey(100 + i)
        c1_before = float(state.c1)
        jstate, jparams = jpso.step(jstate, jparams, jnp.asarray(losses, jnp.float32), key)
        pso.step(state, params, torch.tensor(losses), draws=_jax_draws(key, jparams, "uniform"))
        _compare(jstate, jparams, state, params, i)
        c_moves.append(np.sign(float(state.c1) - c1_before))
    # both thresholds were crossed: c1 fell (ratio > 0.5) and rose (ratio < 0.2)
    assert c_moves[0] == -1 and c_moves[2] == 1
    # the last epoch's best, its losses past the swarm ignored
    assert float(state.gbest_score) == pytest.approx(0.2)


def test_generator_draws_are_the_materialised_ones():
    """`step` with a generator draws what `draws()` materialises from the same
    generator; the swarm and the parameters are on the device of the
    parameters, and every scalar of the state stays a tensor."""
    pso = AdaptivePSO(swarm_size=SWARM)
    init = [torch.from_numpy(a) for a in _params(1).values()]
    runs = []
    for materialise in (False, True):
        params = [p.clone() for p in init]
        state = pso.init(params, torch.Generator().manual_seed(0))
        losses = torch.tensor(LOSSES[0])
        g = torch.Generator().manual_seed(1)
        if materialise:
            pso.step(state, params, losses, draws=pso.draws(params, g))
        else:
            pso.step(state, params, losses, g)
        runs.append((state, params))
    (s0, p0), (s1, p1) = runs
    for a, b in zip(p0 + s0.particles + s0.velocities, p1 + s1.particles + s1.velocities):
        assert torch.equal(a, b)
    assert all(isinstance(getattr(s0, f), torch.Tensor)
               for f in ("pbest_scores", "gbest_score", "c1", "c2", "iteration"))
    # the global best is one particle's pre-update position, now the parameters
    assert any(torch.equal(p0[0], s0.pbest_pos[0][j]) for j in range(SWARM))
