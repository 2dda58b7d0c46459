"""Rank bodies of the port's multi-rank tests (`tests/test_torch_parallel.py`,
`tests/test_torch_zero1.py`, `tests/test_torch_test_cli_ranks.py`), and
`run_ranks`, which starts them.

`run_ranks` starts the ranks through the port's own `parallel.launch`
(spawned interpreters on the CPU, gloo, a `file://` rendezvous in the run's
directory, a 60 s collective timeout and a deadline for the whole run). A
rank unpickles `_body` from this module, which imports torch, numpy and
`ddgan_torch` only (never JAX or a test module); it reads
`<directory>/inputs.pt`, logs to `<directory>/rank<r>.log` and writes
`<directory>/out_<r>.pt`. The JAX references are computed in the test
process and only their inputs cross.
"""

from __future__ import annotations

import datetime
import sys
import time
import types
from pathlib import Path

import torch


def run_ranks(case: str, directory: Path, inputs: dict, world: int = 2,
              timeout_s: float = 150.0) -> list[dict]:
    """Run `case` on `world` ranks with `inputs`; each rank's output. A rank
    that fails or a run past `timeout_s` kills every rank and raises with
    the ranks' logs."""
    from ddgan_torch.parallel import launch

    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, directory / "inputs.pt")
    args = types.SimpleNamespace(case=case, directory=str(directory), what_backend="gloo",
                                 num_process_per_node=world, num_proc_node=1, node_rank=0)
    try:
        launch(args, _body, init_method=f"file://{directory}/rendezvous", device="cpu",
               deadline_s=timeout_s, timeout=datetime.timedelta(seconds=60))
    except RuntimeError as e:
        tails = "\n".join(f"--- rank {r}:\n" + log.read_text()[-3000:]
                          for r in range(world)
                          if (log := directory / f"rank{r}.log").exists())
        raise AssertionError(f"{case} on {world} ranks: {e}\n{tails}") from e
    return [torch.load(directory / f"out_{r}.pt", weights_only=False) for r in range(world)]


def hang(rank: int, local_rank: int, args) -> None:
    """A rank body that never returns (the deadline's test)."""
    del rank, local_rank, args
    while True:
        time.sleep(1)


# ---------------------------------------------------------------- rank bodies
def _models(inp):
    from ddgan_torch.config import Config
    from ddgan_torch.models import DiscriminatorSmall, NCSNpp

    cfg = Config.from_dict(inp["cfg"])
    gen = NCSNpp.from_config(cfg)
    gen.load_state_dict(inp["g_sd"], strict=True)
    disc = DiscriminatorSmall(nc=2 * cfg.num_channels, ngf=cfg.ngf, t_emb_dim=cfg.t_emb_dim)
    disc.load_state_dict(inp["d_sd"], strict=True)
    return cfg, gen, disc


def _coefficients(cfg):
    from ddgan_torch.diffusion import DiffusionCoefficients, PosteriorCoefficients

    return (DiffusionCoefficients.create(cfg.num_timesteps, cfg.beta_min, cfg.beta_max,
                                         device="cpu"),
            PosteriorCoefficients.create(cfg.num_timesteps, cfg.beta_min, cfg.beta_max,
                                         device="cpu"))


def _clone(named) -> dict:
    return {k: v.detach().clone() for k, v in named}


def _shard(t: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    b = t.shape[0] // world
    return t[rank * b:(rank + 1) * b]


def _train_steps(inp, mode: str, group, rank: int, world: int) -> list[dict]:
    """Two train steps (R1, then not) of this rank's shard with injected draws."""
    from ddgan_torch.train import ClippedAdam, StepDraws, Zero1Adam, create_train_state
    from ddgan_torch.train import make_train_step

    cfg, gen, disc = _models(inp)
    cls = Zero1Adam if mode == "zero1" else ClippedAdam
    state = create_train_state(
        gen, disc,
        cls(gen.parameters(), cfg.beta1_g, cfg.beta2_g, 0.0, cfg.grad_clip_norm, group=group),
        cls(disc.parameters(), cfg.beta1_d, cfg.beta2_d, 0.0, cfg.grad_clip_norm, group=group))
    step = make_train_step(*_coefficients(cfg), num_timesteps=cfg.num_timesteps, nz=cfg.nz,
                           r1_gamma=inp["r1_gamma"], lazy_reg=inp["lazy_reg"],
                           ema_decay=inp["ema"], use_ema=True)
    real = _shard(inp["real"], rank, world)
    out = []
    for draws in inp["draws"]:
        m = step(state, real, None, inp["lr"], inp["lr"],
                 draws=StepDraws(*[_shard(a, rank, world) for a in draws]))
        rec = {"metrics": m._asdict(), "params_D": _clone(disc.named_parameters()),
               "params_G": _clone(gen.named_parameters()), "ema": _clone(state.ema_G.items())}
        if mode == "replicated":
            rec["gD"] = {k: p.grad.clone() for k, p in disc.named_parameters()}
            rec["gG"] = {k: p.grad.clone() for k, p in gen.named_parameters()}
        out.append(rec)
    return out


def _pso_steps(inp, group, rank: int, world: int) -> dict:
    """Three PSO steps (swarm 3, trigger 2: the third fires both swarms), data
    and dropout from the rank's generator, the swarms from one seeded alike;
    beside each, the same step without the group on a copy (the rank's own
    losses)."""
    import copy

    from ddgan_torch.train import AdaptivePSO, create_pso_train_state, make_pso_train_step

    cfg, gen, disc = _models(inp)
    pso = AdaptivePSO(swarm_size=3, max_iter=10)
    swarm_rng = torch.Generator().manual_seed(inp["swarm_seed"])
    state = create_pso_train_state(gen, disc, pso, swarm_rng, buf_len=3)
    kw = dict(num_timesteps=cfg.num_timesteps, nz=cfg.nz, ema_decay=inp["ema"], use_ema=True,
              trigger=2)
    step = make_pso_train_step(*_coefficients(cfg), pso, group=group, **kw)
    alone = make_pso_train_step(*_coefficients(cfg), pso, **kw)
    rng = torch.Generator().manual_seed(inp["data_seed"] + rank)
    real = _shard(inp["real"], rank, world)
    meaned, local = [], []
    for _ in range(3):
        twin = copy.deepcopy(state)
        rng_twin, swarm_twin = torch.Generator(), torch.Generator()
        rng_twin.set_state(rng.get_state())
        swarm_twin.set_state(swarm_rng.get_state())
        local.append(alone(twin, real, rng_twin, 0.0, 0.0, swarm_rng=swarm_twin)._asdict())
        meaned.append(step(state, real, rng, 0.0, 0.0, swarm_rng=swarm_rng)._asdict())
    swarms = {name: {k: [t.clone() for t in v] if isinstance(v, list) else v.clone()
                     for k, v in vars(getattr(state, name)).items()}
              for name in ("pso_G", "pso_D")}
    return {"meaned": meaned, "local": local, "swarms": swarms,
            "params_G": _clone(gen.named_parameters()),
            "params_D": _clone(disc.named_parameters()), "ema": _clone(state.ema_G.items()),
            "buf": (state.loss_buf_D.clone(), state.loss_buf_G.clone())}


def _sample(inp, group) -> torch.Tensor:
    from ddgan_torch.diffusion import make_sharded_sampler

    cfg, gen, _ = _models(inp)
    gen.eval()
    _, pos = _coefficients(cfg)
    sample = make_sharded_sampler(pos, gen, cfg.num_timesteps,
                                  (cfg.num_channels, cfg.image_size, cfg.image_size), cfg.nz,
                                  inp["per_device_batch"], group)
    return sample(inp["sample_seed"])


def _zero1_updates(inp, group) -> list[dict]:
    """Three `Zero1Adam` updates of this rank's gradients: each update and
    the gathered moments, the update applied at `lr`."""
    from ddgan_torch.train import Zero1Adam

    params = [torch.nn.Parameter(p.clone()) for p in inp["params"]]
    opt = Zero1Adam(params, inp["b1"], inp["b2"], inp["wd"], inp["clip"], group=group)
    rank = 0 if group is None else torch.distributed.get_rank(group)
    out = []
    for grads in inp["grads"]:
        for p, g in zip(params, grads[rank]):
            p.grad = g.clone()
        upd = opt.update()
        sd = opt.state_dict()
        out.append({"update": upd.clone(), "shard": (opt.mu.numel(), opt.total),
                    "exp_avg": [sd["state"][i]["exp_avg"] for i in range(len(params))],
                    "exp_avg_sq": [sd["state"][i]["exp_avg_sq"] for i in range(len(params))],
                    "step": [float(sd["state"][i]["step"]) for i in range(len(params))]})
        opt.apply_(upd, inp["lr"])
    return out


def _resume(inp, group) -> dict:
    """A ZeRO-1 state loads a replicated run's content.pth and writes it again."""
    from ddgan_torch.config import Config
    from ddgan_torch.parallel import is_main
    from ddgan_torch.train import build_adam_state, build_models
    from ddgan_torch.train import checkpoint as ckpt

    cfg = Config.from_dict(inp["cfg"]).replace(optimizer_sharding="zero1")
    gen, disc = build_models(cfg, torch.Generator().manual_seed(1))
    state = build_adam_state(cfg, gen, disc, group)
    ckpt.load_content(inp["src"], state)
    opts = ckpt.optimizer_states(state)
    if is_main():
        ckpt.save_content(inp["dst"], state, cfg, opts)
    return {"slices": (state.opt_G.mu.clone(), state.opt_D.mu.clone()),
            "shards": (state.opt_G.shard, state.opt_D.shard), "step": state.step}


def _body(rank: int, local_rank: int, args) -> None:
    del local_rank
    from ddgan_torch.parallel import default_group, world_size

    sys.stdout = sys.stderr = open(Path(args.directory) / f"rank{rank}.log", "w", buffering=1)
    torch.set_num_threads(1)
    inp = torch.load(Path(args.directory) / "inputs.pt", weights_only=False)
    group, world = default_group(), world_size()
    if args.case == "parallel":
        out = {"steps": {mode: _train_steps(inp, mode, group, rank, world)
                         for mode in ("replicated", "zero1")},
               "pso": _pso_steps(inp, group, rank, world),
               "sample": _sample(inp, group)}
    elif args.case == "zero1":
        out = {"updates": _zero1_updates(inp, group), "resume": _resume(inp, group)}
    else:
        raise ValueError(f"unknown case {args.case!r}")
    torch.save(out, Path(args.directory) / f"out_{rank}.pt")



def cli_rank_with_fid_recorder(rank: int, local_rank: int, args) -> None:
    """`test_cli.sample_rank` with the FID replaced by a recorder: each call
    appends (rank, the PNGs on disk at that moment) to `args.fid_log` and
    returns 1.25, so that a test sees when and where the FID ran without
    paying for Inception."""
    import ddgan_torch.eval.fid as fid
    import ddgan_torch.eval.inception as inception
    from ddgan_torch.cli import test_cli

    torch.set_num_threads(1)

    def record(paths, **kw):
        with open(args.fid_log, "a") as f:
            f.write(f"{rank} {len(list(Path(paths[0]).glob('*.png')))}\n")
        return 1.25

    fid.calculate_fid_given_paths = record
    inception.default_feature_fn = lambda **kw: None
    test_cli.sample_rank(rank, local_rank, args)
