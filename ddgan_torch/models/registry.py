"""Model registry. (reference: score_sde/models/utils.py:34-57)"""

from __future__ import annotations

_MODELS: dict[str, type] = {}


def register_model(cls=None, *, name: str | None = None):
    """Decorator registering a model class under `name` (or its class name)."""

    def _register(c):
        local_name = name if name is not None else c.__name__
        if local_name in _MODELS:
            raise ValueError(f"Already registered model with name: {local_name}")
        _MODELS[local_name] = c
        return c

    if cls is None:
        return _register
    return _register(cls)


def get_model(name: str) -> type:
    return _MODELS[name]
