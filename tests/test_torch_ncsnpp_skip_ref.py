"""The port's NCSN++ with score_sde's output and input pyramids against the
benchmark's plain reference (`benchmark/reference/nets_skip.py`), on the
CPU, without JAX.

Weights come from `benchmark.weights.fill_weights`, by name, so one draw
fits both; the output's std guards against weights so small that any two
generators agree. f32 within the 1e-4 of `test_torch_ncsnpp_options.py`.
At "none" / "residual" the pyramids' reference is `nets.Generator` bit for
bit. The benchmark's `ffhq1024` configuration (score_sde's FFHQ 1024² widths)
gives the published parameter count, built on the meta device.
"""

import json
from pathlib import Path

import pytest
import torch

from benchmark.reference import nets, nets_skip
from benchmark.reference.ops import Ops
from benchmark.weights import fill_weights
from ddgan_torch.config import Config
from ddgan_torch.models import NCSNpp

ROOT = Path(__file__).resolve().parent.parent
FFHQ = json.loads((ROOT / "benchmark" / "configs" / "ffhq1024.json").read_text())
# the ffhq1024 configuration at a CPU size: image 32, nf 16, three levels,
# one resblock, attention at 8², float32
TINY = {**FFHQ["config"], "image_size": 32, "num_channels_dae": 16, "ch_mult": [1, 2, 2],
        "num_res_blocks": 1, "attn_resolutions": [8], "nz": 8, "z_emb_dim": 16, "n_mlp": 1,
        "compute_dtype": "float32"}
PLAIN = {"progressive": "none", "progressive_input": "residual"}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 3, cfg["image_size"], cfg["image_size"], generator=g)
    return x, torch.tensor([0, 1]), torch.randn(2, cfg["nz"], generator=g)


def _reference(cls, cfg, seed=3):
    ref = cls(cfg)
    fill_weights(ref, seed, "G")
    return ref.eval()


@pytest.mark.parametrize("over", [{}, {"progressive_input": "residual"},
                                  {"progressive": "none"}],
                         ids=["both_pyramids", "output_skip", "input_skip"])
def test_port_matches_the_pyramids_reference(over):
    cfg = {**TINY, **over}
    port = NCSNpp.from_config(Config.from_dict(cfg))
    assert {k: tuple(p.shape) for k, p in port.named_parameters()} == {
        k: tuple(p.shape) for k, p in nets_skip.Generator(cfg).named_parameters()}
    fill_weights(port, 3, "G")
    ref = _reference(nets_skip.Generator, cfg)
    x, t, z = _inputs(cfg)
    with torch.no_grad():
        want = ref(Ops(), x, t, z)
        got = port.eval()(x, t, z)
    assert float(want.std()) > 0.05, "weights are trivial: the comparison would be vacuous"
    assert float((got - want).abs().max()) <= 1e-4


def test_reference_without_pyramids_is_nets_generator_bit_for_bit():
    cfg = {**TINY, **PLAIN}
    x, t, z = _inputs(cfg)
    with torch.no_grad():
        want = _reference(nets.Generator, cfg)(Ops(), x, t, z)
        got = _reference(nets_skip.Generator, cfg)(Ops(), x, t, z)
    assert float(want.std()) > 0.05
    assert torch.equal(got, want)


def test_the_reference_refuses_other_pyramids():
    for over in ({"progressive": "residual"}, {"progressive_input": "none"},
                 {"progressive_combine": "cat"}):
        with pytest.raises(ValueError):
            nets_skip.Generator({**TINY, **over})


def test_ffhq1024_keys_give_the_published_parameter_count():
    cfg = FFHQ["config"]
    with torch.device("meta"):
        port = NCSNpp.from_config(Config.from_dict(cfg))
        ref = nets_skip.Generator(cfg)
    want = FFHQ["published"]["generator_parameters"]
    assert want == 118_746_648
    assert sum(p.numel() for p in port.parameters()) == want
    assert sum(p.numel() for p in ref.parameters()) == want
