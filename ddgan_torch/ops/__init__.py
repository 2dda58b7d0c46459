from . import fir2x, pair_conv, resample  # noqa: F401
from .upfirdn2d import upfirdn2d_ref  # noqa: F401
