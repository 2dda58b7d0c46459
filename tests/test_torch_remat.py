"""`use_remat` / `remat_policy` in the port's NCSN++ (each resblock under a
non-reentrant `torch.utils.checkpoint`) on the CPU.

With remat on, under "full" and "save-convs", the generator's output, every
gradient and the dropout generator's state afterwards equal the run without
remat bit for bit (dropout 0.1, masks from a dropout generator), in a
forward and backward of the tiny flagship and in two train steps (R1, then
not); through the gated conv's route (bf16 at 128², nf 64) too. Under
"save-convs" no 3x3 or 1x1 conv of a resblock is computed again in the
backward, the gated conv included, while "full" recomputes each one. The
JAX package's remat-yes gradients equal the port's remat-yes gradients
within the tolerance of `test_torch_ncsnpp_options.py::
test_gradients_match_jax`, and the keys resolve as the JAX package resolves
them, "auto" apart (off in the port at every size: PERF.md §5, PR 12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddgan_tpu.models import NCSNpp as JNCSNpp

from ddgan_torch.compat import state_dict_from_flax
from ddgan_torch.diffusion import DiffusionCoefficients, PosteriorCoefficients
from ddgan_torch.models import DiscriminatorSmall, NCSNpp
from ddgan_torch.models import ncsnpp as tncsnpp
from ddgan_torch.ops import fir2x, pair_conv
from ddgan_torch.train import ClippedAdam, create_train_state, make_train_step
from ddgan_torch.utils import randomize_parameters_

from _torch_port import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    chip_smoke,
    jax_variables,
    nchw,
    one_torch_thread,
    randn,
    tiny_config,
)

SMOKE = chip_smoke()
POLICIES = [("yes", "full"), (True, "save-convs")]
POLICY_IDS = ["yes_full", "true_save_convs"]


@pytest.fixture
def count_convs():
    """Counts of the convs of `nn/layers.py` that run (a replayed output is
    not run), as `chip_smoke.py` phase 53 counts them."""
    with SMOKE.counting_convs() as counts:
        yield counts


def _forward_backward(cfg, counts, seed=3, batch=2):
    net = randomize_parameters_(NCSNpp.from_config(cfg), seed).train()
    rng = torch.Generator().manual_seed(11)
    net.set_dropout_generator(rng)
    x = nchw(randn(1, batch, cfg.image_size, cfg.image_size, 3))
    t, z = torch.tensor([0, 3][:batch]), torch.from_numpy(randn(2, batch, cfg.nz))
    pair_conv.reset_launch_counts()
    fir2x.reset_launch_counts()
    counts["convs"] = 0
    out = net(x, t, z)
    fwd = {"convs": counts["convs"], "k2": pair_conv.CALLS["forward"],
           "fir": {k: v["forward"] for k, v in fir2x.CALLS.items()}}
    (out.float() * nchw(randn(4, *out.permute(0, 2, 3, 1).shape))).sum().backward()
    bwd = {"convs": counts["convs"] - fwd["convs"],
           "k2": pair_conv.CALLS["forward"] - fwd["k2"],
           "fir": {k: v["forward"] - fwd["fir"][k] for k, v in fir2x.CALLS.items()}}
    grads = {k: p.grad for k, p in net.named_parameters()}
    return out.detach(), grads, rng.get_state(), bwd


def _assert_same(a, b):
    (out_a, grads_a, rng_a, _), (out_b, grads_b, rng_b, _) = a, b
    assert torch.equal(out_a, out_b)
    assert grads_a.keys() == grads_b.keys()
    for k in grads_a:
        assert torch.equal(grads_a[k], grads_b[k]), k
    assert torch.equal(rng_a, rng_b)


@pytest.mark.parametrize("use_remat,policy", POLICIES, ids=POLICY_IDS)
def test_remat_equals_no_remat_bit_for_bit(use_remat, policy, count_convs):
    cfg = tiny_config(dropout=0.1, use_remat="no")
    base = _forward_backward(cfg, count_convs)
    assert base[3]["convs"] == 0 and base[3]["fir"] == {"down2x": 0, "up2x": 0}
    got = _forward_backward(cfg.replace(use_remat=use_remat, remat_policy=policy), count_convs)
    _assert_same(base, got)
    # the FIR resampling of the BigGAN blocks runs again under either policy
    assert got[3]["fir"] == {"down2x": 2, "up2x": 2}
    if policy == "save-convs":
        assert got[3]["convs"] == 0
    else:  # every conv of every resblock but the last conv that saves before it runs
        assert got[3]["convs"] >= 20


def test_remat_through_the_gated_conv_bit_for_bit(count_convs):
    """bf16 at 128² with nf 64: the resblocks' 3x3 convs take the gated conv
    route (K2 on the GPU, its plain version here), which "full" recomputes
    and "save-convs" does not."""
    cfg = tiny_config(image_size=128, num_channels_dae=64, ch_mult=[1, 1, 2],
                      attn_resolutions=[], compute_dtype="bfloat16", dropout=0.1, use_remat="no")
    base = _forward_backward(cfg, count_convs, batch=1)
    assert base[3]["k2"] == 0
    for policy in ("full", "save-convs"):
        got = _forward_backward(cfg.replace(use_remat="yes", remat_policy=policy), count_convs,
                                batch=1)
        _assert_same(base, got)
        if policy == "save-convs":
            assert got[3]["k2"] == 0 and got[3]["convs"] == 0
        else:  # every gated conv of the forward sits in a resblock
            assert got[3]["k2"] == pair_conv.CALLS["forward"] - got[3]["k2"] == 8


@pytest.mark.parametrize("use_remat,policy", [("no", "full"), ("yes", "full")],
                         ids=["off", "full"])
def test_convs_skip_conv_out_outside_save_convs(use_remat, policy, monkeypatch):
    """Without a "save-convs" block running, the conv layers call their
    function directly and never reach `conv_out`."""
    from ddgan_torch.nn import layers

    monkeypatch.setattr(layers, "conv_out", lambda *a: pytest.fail("conv_out reached"))
    cfg = tiny_config(dropout=0.1, use_remat=use_remat, remat_policy=policy)
    _forward_backward(cfg, {"convs": 0})
    assert layers._SAVING == 0


def _train_two_steps(cfg):
    gen = NCSNpp.from_config(cfg, generator=torch.Generator().manual_seed(0))
    randomize_parameters_(gen, 2)
    disc = DiscriminatorSmall(nc=6, ngf=cfg.ngf, t_emb_dim=cfg.t_emb_dim)
    disc.init_weights(torch.Generator().manual_seed(1))
    state = create_train_state(gen, disc, ClippedAdam(gen.parameters(), 0.5, 0.9),
                               ClippedAdam(disc.parameters(), 0.5, 0.9))
    step = make_train_step(
        DiffusionCoefficients.create(4, 0.1, 20.0, device="cpu"),
        PosteriorCoefficients.create(4, 0.1, 20.0, device="cpu"),
        num_timesteps=4, nz=cfg.nz, r1_gamma=0.02, lazy_reg=2, ema_decay=0.99, use_ema=True)
    rng = torch.Generator().manual_seed(9)
    real = torch.rand((2, 3, 16, 16), generator=torch.Generator().manual_seed(5)) * 2 - 1
    fir2x.reset_launch_counts()
    losses = [float(step(state, real, rng, 1e-3, 1e-3).errG) for _ in range(2)]
    tensors = {**{f"G.{k}": p.detach() for k, p in gen.named_parameters()},
               **{f"G.grad.{k}": p.grad for k, p in gen.named_parameters()},
               **{f"ema.{k}": v for k, v in state.ema_G.items()}}
    return losses, tensors, rng.get_state(), {k: dict(v) for k, v in fir2x.CALLS.items()}


@pytest.mark.parametrize("policy", ["full", "save-convs"])
def test_two_train_steps_with_remat_equal_without(policy):
    """Two steps (R1, then not) at dropout 0.1 from one seed: losses, G's
    weights, its last gradients, the EMA and the step generator's state; the
    FIR calls by role as `chip_smoke.expected_fir_calls` counts them, with
    the recompute term under remat."""
    cfg = tiny_config(dropout=0.1, use_remat="no")
    base = _train_two_steps(cfg)
    got = _train_two_steps(cfg.replace(use_remat="yes", remat_policy=policy))
    assert got[0] == base[0]
    for k in base[1]:
        assert torch.equal(got[1][k], base[1][k]), k
    assert torch.equal(got[2], base[2])
    for calls, remat in ((base[3], False), (got[3], True)):
        assert calls == SMOKE.expected_run_calls(range(2), 2, 3, 1, shared=False, remat=remat)


def test_remat_gradients_match_jax_remat():
    """d/dθ of sum(out · r) with use_remat 'yes' in both packages (JAX's
    `nn.remat` of each ResnetBlock, the port's checkpoint), every parameter
    within 1e-4 of each tensor's largest magnitude."""
    cfg = tiny_config(use_remat="yes", remat_policy="save-convs")
    gen, net = JNCSNpp.from_config(cfg), randomize_parameters_(NCSNpp.from_config(cfg), 4).eval()
    assert gen.use_remat and net.use_remat and net.remat_policy == "save-convs"
    variables = jax_variables(gen, cfg, net)
    x, z = randn(20, 2, 16, 16, 3), randn(21, 2, cfg.nz)
    t = np.array([1, 3], np.int32)
    r = randn(30, *x.shape)

    def loss(p):
        out = gen.apply({**variables, "params": p}, jnp.asarray(x), jnp.asarray(t),
                        jnp.asarray(z), train=False)
        return (out * jnp.asarray(r)).sum()

    want = state_dict_from_flax(jax.tree.map(np.asarray,
                                             jax.jit(jax.grad(loss))(variables["params"])))
    out = net(nchw(x), torch.from_numpy(t).long(), torch.from_numpy(z))
    (out * nchw(r)).sum().backward()
    top = max(float(v.abs().max()) for v in want.values())
    for k, p in net.named_parameters():
        if k.endswith("NIN_1.b"):  # attention's key bias: zero in exact arithmetic
            assert max(float(p.grad.abs().max()), float(want[k].abs().max())) < 1e-7 * top, k
            continue
        scale = float(want[k].abs().max())
        assert scale > 1e-6 * top, k
        assert float((p.grad - want[k]).abs().max()) <= 1e-4 * scale, k


@pytest.mark.parametrize("raw", ["auto", "yes", "YES", "true", "1", "no", "false", "0", "maybe",
                                 True, False, 1, 0])
@pytest.mark.parametrize("image_size", [16, 256])
def test_use_remat_resolves_as_the_jax_package(raw, image_size):
    cfg = tiny_config(use_remat=raw, image_size=image_size)
    want = JNCSNpp.from_config(cfg).use_remat
    got = tncsnpp.resolve_use_remat(cfg)
    if raw == "auto" and image_size >= 256:
        assert want and not got  # measured slower on the H100: off at every size
    else:
        assert got == want


def test_remat_policy_env_and_refusal(monkeypatch):
    """The policy comes from remat_policy alone: the port does not read the
    JAX package's $DDGAN_TPU_REMAT_POLICY. An unknown policy raises in both
    packages once remat is on, and is never read with it off."""
    cfg = tiny_config(use_remat="yes", remat_policy="full")
    monkeypatch.setenv("DDGAN_TPU_REMAT_POLICY", "save-convs")
    assert NCSNpp.from_config(cfg).remat_policy == "full"
    assert NCSNpp.from_config(cfg.replace(remat_policy="SAVE_CONVS")).remat_policy == "save-convs"
    monkeypatch.delenv("DDGAN_TPU_REMAT_POLICY")
    cfg = cfg.replace(remat_policy="bogus")
    assert NCSNpp.from_config(cfg.replace(use_remat="no")).remat_policy is None
    with pytest.raises(ValueError, match="remat_policy='bogus' not recognized"):
        NCSNpp.from_config(cfg)
    k = jax.random.PRNGKey(0)
    with pytest.raises(ValueError, match="remat_policy='bogus' not recognized"):
        jax.eval_shape(lambda: JNCSNpp.from_config(cfg).init(
            {"params": k, "dropout": k}, jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, cfg.nz))))
