"""Shared pieces of the benchmark's own tests. Run them from the repository
root with `python -m pytest benchmark/tests -q`; the tests that need a CUDA
card carry the `cuda` marker and skip without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = dict(num_channels_dae=8, ch_mult=[1, 2], attn_resolutions=[8], nz=4, z_emb_dim=8,
            n_mlp=1, t_emb_dim=8, ngf=4, image_size=16, batch_size=8)


# DiscriminatorLarge halves its input six times: its tiny cells run at 64²
# with six generator levels
LARGE = dict(image_size=64, ch_mult=[1, 1, 2, 2, 4, 4])


def tiny_cell(name: str, **overrides):
    """The cell `name` with its configuration cut to a CPU-sized tiny one
    (widths and depth), its limits as committed."""
    from benchmark import harness

    cell = harness.load_cell(name)
    large = str(cell.cfg.get("disc_small", "yes")).lower() != "yes"
    cfg = {**cell.cfg, **TINY, **(LARGE if large else {}), **overrides}
    cell.config = {**cell.config, "config": cfg, "reference_rows": None}
    return cell


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
