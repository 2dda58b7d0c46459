"""Hyperparameter-space particle swarm (reference: pso.py:123-299), the
port's copy of `ddgan_tpu/pso/search.py`: the same `random.Random` streams,
so the same evaluate_fn and seed give the same trajectory.

Faithful semantics: int dims snap to the step grid and clamp
(pso.py:183-194); velocities init uniform in ±(max-min); inertia anneals
0.9 → 0.4 when clamping is on (pso.py:252-255); early stop after
iteration 5 on <1e-3 improvement (pso.py:295-297).
"""

from __future__ import annotations

import json
import logging
import random
from typing import Callable, Dict

logger = logging.getLogger("ddgan_torch.pso")


class Particle:
    """One hyperparameter sample + velocity. (pso.py:123-195)"""

    def __init__(self, search_space: Dict, seed: int = 42):
        self.seed = seed
        rng = random.Random(seed)
        self.position: Dict = {}
        self.velocity: Dict = {}
        self.best_score = float("inf")

        for param, bounds in search_space.items():
            if param == "step":
                continue
            min_val, max_val = bounds
            if isinstance(min_val, int):
                step = search_space.get("step", {}).get(param, 1)
                possible = list(range(min_val, max_val + 1, step))
                self.position[param] = rng.choice(possible)
            else:
                self.position[param] = rng.uniform(min_val, max_val)
            self.velocity[param] = rng.uniform(-(max_val - min_val), max_val - min_val)
        self.best_position = self.position.copy()

    def update_velocity(self, global_best_position: Dict, c1: float, c2: float,
                        w: float, max_velocity: float | None = None,
                        rng: random.Random | None = None):
        rng = rng or random
        for param in self.position:
            r1, r2 = rng.random(), rng.random()
            cognitive = c1 * r1 * (self.best_position[param] - self.position[param])
            social = c2 * r2 * (global_best_position[param] - self.position[param])
            self.velocity[param] = w * self.velocity[param] + cognitive + social
            if max_velocity is not None:
                self.velocity[param] = max(
                    -max_velocity, min(self.velocity[param], max_velocity)
                )

    def update_position(self, search_space: Dict):
        for param in self.position:
            self.position[param] += self.velocity[param]
            min_val, max_val = search_space[param]
            if isinstance(min_val, int):
                step = search_space.get("step", {}).get(param, 1)
                self.position[param] = int(round(self.position[param] / step) * step)
            self.position[param] = max(min_val, min(self.position[param], max_val))


class PSO:
    """Swarm over the hyperparameter space. (pso.py:198-299)

    evaluate_fn(position: dict, seed: int) -> float (lower is better).
    """

    def __init__(
        self,
        search_space: Dict,
        evaluate_fn: Callable[[Dict, int], float],
        num_particles: int = 10,
        num_iterations: int = 20,
        c1: float = 1.5,
        c2: float = 1.5,
        w: float = 0.7,
        do_clamping: bool = False,
        use_multiprocessing: bool = False,
        seed: int = 42,
    ):
        self.search_space = search_space
        self.evaluate_fn = evaluate_fn
        self.num_particles = num_particles
        self.num_iterations = num_iterations
        self.c1, self.c2, self.w = c1, c2, w
        self.use_multiprocessing = use_multiprocessing
        self.max_velocity = 1.0 if do_clamping else None
        self.seed = seed
        self._rng = random.Random(seed)

        self.particles = [
            Particle(search_space, seed=seed + i) for i in range(num_particles)
        ]
        self.global_best_position = self.particles[0].position.copy()
        self.global_best_score = float("inf")

    def optimize(self) -> Dict:
        prev_best = float("inf")
        for iteration in range(self.num_iterations):
            logger.info(f"Iteration {iteration + 1}/{self.num_iterations}")
            if self.max_velocity is not None:
                # inertia annealing 0.9 → 0.4 (pso.py:252-255)
                self.w = max(0.9 - iteration * (0.5 / self.num_iterations), 0.4)

            positions = [p.position for p in self.particles]
            seeds = [
                self.seed + i + iteration * self.num_particles
                for i in range(self.num_particles)
            ]
            if self.use_multiprocessing:
                # forked workers, as the JAX package's pool (a forked
                # process cannot use CUDA: evaluate.check_pool refuses that)
                import multiprocessing

                with multiprocessing.Pool(
                    processes=min(self.num_particles, multiprocessing.cpu_count())
                ) as pool:
                    results = pool.starmap(self.evaluate_fn, zip(positions, seeds))
            else:
                results = [
                    self.evaluate_fn(pos, seed) for pos, seed in zip(positions, seeds)
                ]

            for i, particle in enumerate(self.particles):
                score = results[i]
                logger.info(f"Particle {i + 1}/{self.num_particles}, Score: {score}")
                if score < particle.best_score:
                    particle.best_score = score
                    particle.best_position = particle.position.copy()
                if score < self.global_best_score:
                    self.global_best_score = score
                    self.global_best_position = particle.position.copy()

            for particle in self.particles:
                particle.update_velocity(
                    self.global_best_position, self.c1, self.c2, self.w,
                    self.max_velocity, rng=self._rng,
                )
                particle.update_position(self.search_space)

            logger.info(f"Global best score: {self.global_best_score}")
            if iteration > 5 and abs(prev_best - self.global_best_score) < 1e-3:
                logger.info("Stopping early due to minimal improvement.")
                break
            prev_best = self.global_best_score

        return self.global_best_position

    def save_best(self, path: str = "best_hyperparameters.json") -> None:
        with open(path, "w") as f:
            json.dump(self.global_best_position, f, indent=4)
