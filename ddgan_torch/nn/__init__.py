from .blocks import (  # noqa: F401
    AdaptiveGroupNorm,
    AttnBlockpp,
    Downsample,
    FirConv2d,
    GroupNorm,
    HeadGroupNorm,
    ResnetBlockBigGANppAdagn,
    Upsample,
)
from .layers import (  # noqa: F401
    NIN,
    Conv1x1,
    Conv3x3,
    Dense,
    Linear,
    PixelNorm,
    default_init,
    dense_init,
    get_timestep_embedding,
)
