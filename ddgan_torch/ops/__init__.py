from . import fir2x, resample  # noqa: F401
from .upfirdn2d import upfirdn2d_ref  # noqa: F401
