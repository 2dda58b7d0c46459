"""Alternate PSO runner (reference pso_run.py; the root `pso_run.py` is the
JAX package's): a search space JSON whose bounds may be strings
("[1e-6, 1e-3]"), batch_size put on the int-step grid, stability scoring.
Run as

    python -m ddgan_torch.pso.run --search_space ./search_space_params.json

from a working directory holding ./configs/config.json (see `pso/cli.py`).
"""

from __future__ import annotations

import argparse
import ast
import json

from .evaluate import make_evaluator
from .search import PSO


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--search_space", type=str,
                        default="./search_space_params.json")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--num_particles", type=int, default=10)
    parser.add_argument("--num_iterations", type=int, default=20)
    args = parser.parse_args(argv)

    with open(args.search_space) as f:
        search_space = json.load(f)
    for key, val in search_space.items():
        if key == "step":
            continue
        if isinstance(val, str):
            search_space[key] = ast.literal_eval(val)
    search_space.setdefault("step", {})["batch_size"] = args.batch_size

    pso = PSO(
        search_space,
        evaluate_fn=make_evaluator(scoring="stability"),
        num_particles=args.num_particles,
        num_iterations=args.num_iterations,
    )
    pso.optimize()
    pso.save_best()
    return pso.global_best_position


if __name__ == "__main__":
    main()
