"""Name → model-class registry (port of ``distkeras_tpu.models.registry``)."""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register_model(name: str):
    """Class decorator: register a model class under ``name``."""

    def deco(cls):
        _REGISTRY[name] = cls
        cls._registry_name = name
        return cls

    return deco


def get_model(name: str, **kwargs):
    """Instantiate a registered model by name."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"Unknown model '{name}'. Known: {sorted(_REGISTRY)}") from None
    return cls(**kwargs)


def model_spec(module) -> dict:
    """``{name, kwargs}`` spec of a registered module instance: its
    registry name and constructor keywords (``module.config()``; the
    device and seed are not part of it)."""
    name = getattr(type(module), "_registry_name", None)
    if name is None:
        raise ValueError(f"{type(module).__name__} is not a registered model")
    return {"name": name, "kwargs": module.config()}
