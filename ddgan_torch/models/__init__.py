from .discriminator import (  # noqa: F401
    DiscriminatorLarge,
    DiscriminatorSmall,
    build_discriminator,
    minibatch_stddev,
)
from .ncsnpp import NCSNpp, resolve_compute_dtype  # noqa: F401
from .registry import get_model, register_model  # noqa: F401
