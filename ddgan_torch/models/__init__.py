from .ncsnpp import NCSNpp, resolve_compute_dtype  # noqa: F401
from .registry import get_model, register_model  # noqa: F401
