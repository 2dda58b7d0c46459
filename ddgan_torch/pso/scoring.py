"""Evaluation scoring for PSO hyperparameter search (the port's copy of
`ddgan_tpu/pso/scoring.py`).

Two scoring variants from the reference:
  A. combined 0.5*norm(loss) + 0.5*norm(FID) (pso.py:333-350). QUIRK FIXED
     TO INTENT: the reference reads `final_loss.txt` which ddgan.py never
     writes, degenerating the loss half to a constant (SURVEY.md §2.6);
     our training loop DOES write it (train/loop.py), so the score works.
  B. GAN loss-stability: mean per-epoch penalty for G/D losses outside
     G=1.0±0.5, D=1.3±0.3 (pso-optim.py:396-445).
"""

from __future__ import annotations

import json
import logging
import os

logger = logging.getLogger("ddgan_torch.pso")


def normalize_score(score: float, score_min: float, score_max: float) -> float:
    """Clamp-normalize to [0,1]. (pso.py:468-483)"""
    if score_max == score_min:
        return 0.0
    return max(0.0, min(1.0, (score - score_min) / (score_max - score_min)))


def compute_loss(exp_path: str) -> float:
    """Final generator loss from final_loss.txt; inf if absent. (pso.py:405-422)"""
    loss_file = os.path.join(exp_path, "final_loss.txt")
    if os.path.exists(loss_file):
        with open(loss_file) as f:
            return float(f.readline().strip())
    return float("inf")


def loss_stability_score(
    exp_path: str,
    target_g: float = 1.0,
    target_d: float = 1.3,
    tolerance_g: float = 0.5,
    tolerance_d: float = 0.3,
) -> float:
    """Mean out-of-band deviation of per-epoch G/D losses.
    (pso-optim.py:396-445)"""
    losses_file = os.path.join(exp_path, "losses.json")
    if not os.path.exists(losses_file):
        logger.error(f"Losses file not found at {losses_file}.")
        return float("inf")
    try:
        with open(losses_file) as f:
            losses = json.load(f)
    except Exception as e:  # noqa: BLE001 - reference behavior
        logger.error(f"Failed to read losses file: {e}")
        return float("inf")
    if not isinstance(losses, list) or not losses:
        return float("inf")

    total = 0.0
    for loss in losses:
        g, d = loss.get("G_loss"), loss.get("D_loss")
        if g is None or d is None:
            return float("inf")
        dev_g, dev_d = abs(g - target_g), abs(d - target_d)
        total += (dev_g if dev_g > tolerance_g else 0.0) + (
            dev_d if dev_d > tolerance_d else 0.0
        )
    return total / len(losses)


def combined_score(
    loss_score: float,
    fid_score: float,
    loss_min: float = 0.0,
    loss_max: float = 1.0,
    fid_min: float = 0.0,
    fid_max: float = 300.0,
    loss_weight: float = 0.5,
    fid_weight: float = 0.5,
) -> float:
    """0.5*norm(loss) + 0.5*norm(fid). (pso.py:341-350)"""
    return loss_weight * normalize_score(loss_score, loss_min, loss_max) + (
        fid_weight * normalize_score(fid_score, fid_min, fid_max)
    )
