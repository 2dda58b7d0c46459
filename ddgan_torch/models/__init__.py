from .discriminator import (  # noqa: F401
    DiscriminatorLarge,
    DiscriminatorSmall,
    build_discriminator,
    minibatch_stddev,
)
from .ncsnpp import NCSNpp, resolve_compute_dtype  # noqa: F401
from .registry import (  # noqa: F401
    create_model,
    get_ddpm_params,
    get_model,
    get_model_fn,
    get_sigmas,
    register_model,
)
