"""PSO hyperparameter search (outer HPO loop), the port's counterpart of
`ddgan_tpu/pso/`.

Reference: pso.py (combined loss+FID scoring), pso-optim.py (GAN
loss-stability scoring), pso_run.py. The swarm and the scoring are copies
of the JAX package's; the evaluator trains with `ddgan_torch.train` in this
process (the default) or through the port's train CLI in a subprocess.
Entry points: `python -m ddgan_torch.pso.cli` and `python -m
ddgan_torch.pso.run`."""

from .search import Particle, PSO  # noqa: F401
from .scoring import (  # noqa: F401
    normalize_score,
    compute_loss,
    loss_stability_score,
)
from .evaluate import make_evaluator  # noqa: F401
from .vali_show import SimpleShow  # noqa: F401
